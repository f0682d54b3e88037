"""95th percentile over the window's steps of the ms from the step's last
arrival to the end of the fetch's ``source.wait`` for it: how late the
driving thread wakes, in the detection cell."""
from harness import readers


def read(win):
    return readers.fetch_lag_ms_p95(win)
