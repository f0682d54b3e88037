"""Driver-thread ms a step in ``source.copy`` spans with ``early`` false:
the copy after the step's last arrival, which the step waits for, in
the detection cell."""
from harness import readers


def read(win):
    return readers.span_ms_per_step(win, "source.copy", early=False)
