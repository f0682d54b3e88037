"""Driver-thread ms a step in ``h2d.stage``: copies into pinned memory
(mask, scales, rows; the payload fills its slot in ``source.copy``), in
the detection cell."""
from harness import readers


def read(win):
    return readers.span_ms_per_step(win, "h2d.stage")
