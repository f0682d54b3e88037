"""The event detection's share of its roofline in the detection cell: the
frozen cost (``costs/detect_events.py``) of the window's calls of
``ops.detect_events`` (K6) over the device time of what they
launched."""
from harness import readers


def read(win):
    return readers.roofline_pct(win, "detect_events")
