"""Wav dataset IO (``wavio``), a copy of the reference's."""
