"""Share of the records copied out of the ring while a record of the same
step was still to land (``source.copy``'s ``records`` and ``early``), in
the detection cell."""
from harness import readers


def read(win):
    return readers.early_copy_pct(win)
