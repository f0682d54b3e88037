"""Command-line entry points (``depam_run``)."""
