"""The Welch PSD's share of its roofline in the detection cell: the frozen
cost (``costs/welch_psd.py``) of the window's calls of ``ops.welch_psd``
(K2 then K3 on paper set 2) over the device time of what they
launched."""
from harness import readers


def read(win):
    return readers.roofline_pct(win, "welch_psd")
