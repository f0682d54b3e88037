"""95th percentile over the window's steps of the ms from the step's last
arrival (the push stamp its last ``source.wait`` carries as ``ready_ns``)
to the end of its ``job.drain``: the program's work after the last push,
in the live cell."""
from harness import readers


def read(win):
    return readers.ready_to_sink_ms_p95(win)
