"""Producer-thread ms a step in ``source.push_wait``: pushes waiting for
the ring's lock or for room, in the detection cell."""
from harness import readers


def read(win):
    return readers.span_ms_per_step(win, "source.push_wait", driver=False)
