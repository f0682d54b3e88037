"""Share of the traced window in which the device is idle and the driving
thread's innermost program span is not ``source.wait``: idle on the
host's work rather than on arrivals, in the detection cell."""
from harness import readers


def read(win):
    return readers.host_bound_idle_pct(win)
