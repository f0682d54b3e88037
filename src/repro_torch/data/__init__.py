"""Wav dataset IO (``wavio``) and the prefetching loader (``loader``),
copies of the reference's."""
