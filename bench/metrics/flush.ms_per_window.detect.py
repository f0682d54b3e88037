"""Driver-thread ms to finalize and hand the sink one closed window (the
program's ``job.flush`` spans: their ms summed over the ``windows`` they
wrote), in the detection cell.  Nothing where no window was flushed or
the program has no such span."""
from harness import readers


def read(win):
    p = readers.program(win)
    flush = [] if p is None else p.named("job.flush")
    windows = sum(s.attrs["windows"] for s in flush)
    if not windows:
        return None
    return sum(s.end_ns - s.start_ns for s in flush) / 1e6 / windows
