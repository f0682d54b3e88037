"""ops.tol_levels: the frozen cost's least time over the device time of the
kernels its calls launched in the window, in the live cell."""
from harness import readers


def read(win):
    return readers.roofline_pct(win, "tol_levels")
