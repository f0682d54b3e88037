"""Command-line entry points (``depam_run``) and host meshes
(``mesh``)."""
