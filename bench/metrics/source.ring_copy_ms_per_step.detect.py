"""Driver-thread ms a step in ``source.copy``: every copy out of the ring
into the step's staging buffer, in the detection cell."""
from harness import readers


def read(win):
    return readers.span_ms_per_step(win, "source.copy")
