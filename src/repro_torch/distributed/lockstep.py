"""Host-driven collectives: one body per mesh position, run in lock step.

The reference expresses a collective inside ``shard_map`` (``pmax``,
``psum``).  The port has one process, so each position's body is a
generator that yields ``("max" | "sum", tree of tensors)`` where the
reference calls the collective; ``run_lockstep`` combines the values of
each group in member order on one device and sends the result back to
every member on its own device, then resumes the bodies together.  The
sequence-sharded decode (``models.attention.DecodeShards``) and the
cross-pod gradient reduction (``optim.compress``) run on it.
"""
from __future__ import annotations

import torch

from repro_torch.models.module import tree_map


def run_lockstep(bodies: list, devices: list, groups, home) -> list:
    """Drive ``bodies[i]`` (on ``devices[i]``) in lock step.  At each
    collective the values of every group in ``groups`` (tuples of body
    indices) are combined in member order on ``home`` -- ``max`` by
    ``torch.maximum``, ``sum`` by ``torch.add`` -- and sent back to each
    member on its own device.  Every body must end at the same
    collective count; returns their return values."""
    vals = [next(b) for b in bodies]
    while True:
        sent = [None] * len(bodies)
        for members in groups:
            op = torch.maximum if vals[members[0]][0] == "max" \
                else torch.add
            red = None
            for i in members:
                v = tree_map(lambda t: t.to(home), vals[i][1])
                red = v if red is None else tree_map(op, red, v)
            for i in members:
                sent[i] = tree_map(lambda t, d=devices[i]: t.to(d), red)
        done, nxt = [], []
        for b, v in zip(bodies, sent):
            try:
                nxt.append(b.send(v))
            except StopIteration as e:   # every body ends together
                done.append(e.value)
        if done:
            return done
        vals = nxt
