"""Driver-thread ms a step in ``drain.compact``: the host compaction of the
step's event slabs into the rows the sink gets, in the detection cell.
Nothing where the program has no such span."""
from harness import readers


def read(win):
    p = readers.program(win)
    if p is None or not p.named("drain.compact"):
        return None
    return readers.span_ms_per_step(win, "drain.compact")
