"""The per-frame PSD's share of its roofline in the detection cell: the
frozen cost (``costs/frame_psd.py``) of the window's calls of
``ops.frame_psd`` (K2 on paper set 2) over the device time of what they
launched."""
from harness import readers


def read(win):
    return readers.roofline_pct(win, "frame_psd")
