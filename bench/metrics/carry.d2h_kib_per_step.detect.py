"""KiB of the window carry a step sends to the host (the ``d2h_bytes`` of
the program's ``job.carry`` spans, summed, over the window's steps), in
the detection cell.  Nothing where the program has no such span."""
from harness import readers


def read(win):
    p = readers.program(win)
    carry = [] if p is None else p.named("job.carry")
    if not carry:
        return None
    sent = sum(s.attrs["d2h_bytes"] for s in carry)
    return sent / 1024 / len(p.named("job.step"))
