"""95th percentile over the window's steps of the ms from the step's last
arrival to the end of its ``job.drain``, in the detection cell."""
from harness import readers


def read(win):
    return readers.ready_to_sink_ms_p95(win)
