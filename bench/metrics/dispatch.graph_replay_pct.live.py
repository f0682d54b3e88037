"""Share of the step's chain runs (the program's plain-PyTorch chains:
the frame statistics, the carry update) that a CUDA graph replay served:
the ``replays`` of the program's ``job.dispatch`` spans over all their
counted runs (``replays``, ``captures``, ``eager``), in the live
cell.  Nothing where the spans carry no such count."""
from harness import readers


def read(win):
    p = readers.program(win)
    spans = [] if p is None else [s for s in p.named("job.dispatch")
                                  if "replays" in s.attrs]
    runs = sum(s.attrs["replays"] + s.attrs["captures"] + s.attrs["eager"]
               for s in spans)
    if not runs:
        return None
    return 100.0 * sum(s.attrs["replays"] for s in spans) / runs
