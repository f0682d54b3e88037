"""Share of the traced window in which nothing ran on the device, in the
detection cell."""
from harness import readers


def read(win):
    return readers.idle_pct(win)
