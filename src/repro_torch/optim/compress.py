"""Hierarchical gradient compression for the cross-pod axis.

The reference compresses only the cross-pod all-reduce: inside a pod,
gradients reduce in full precision; across pods, each pod quantizes
(g + e) to int8 with a shared per-tensor scale, the int8 payloads are
summed exactly, and the quantization residual e is carried in the train
state (error feedback, which keeps SGD unbiased in the long run;
Karimireddy et al., 2019).

The reference runs this inside a ``shard_map`` whose pod axis is
manual.  The port has one process: each pod's reduction is a body run
in lock step with the others (``distributed.lockstep``), on its pod's
device.  The shared scale is the max over the pods; the int8 payloads
are summed in int32, in pod order, on the first pod's device, and the
sum is sent back to each pod's device.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.lockstep import run_lockstep
from repro_torch.models.layers import upcast
from repro_torch.models.module import leaves_with_path, unflatten


def quantize(g: torch.Tensor, err: torch.Tensor | None):
    """(g + err) -> (int8 payload, scale, new_err)."""
    gf = upcast(g)
    if err is not None:
        gf = gf + err
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(gf.dtype) * scale
    return q, scale, new_err


def _pod_body(g_l: list, e_l: list, n: int):
    """One pod's reduction of its leaves: yields its local maxima, then
    its int8 payloads (as int32); returns (mean leaves, new error
    leaves)."""
    lim = 127 // n
    gf = [upcast(g) + e for g, e in zip(g_l, e_l)]
    scales = yield ("max", [torch.amax(torch.abs(x)) for x in gf])
    steps = [torch.clamp(s, min=1e-30) / lim for s in scales]  # quantum
    q = [torch.clamp(torch.round(x / st), -lim, lim).to(torch.int8)
         for x, st in zip(gf, steps)]
    totals = yield ("sum", [t.to(torch.int32) for t in q])
    mean = [t.to(x.dtype) * st / n for t, x, st in zip(totals, gf, steps)]
    new_e = [x - t.to(x.dtype) * st for x, t, st in zip(gf, q, steps)]
    return mean, new_e


def crosspod_reduce(grads: list, err: list | None, devices: list):
    """Mean-reduce one gradient tree per pod (``grads[i]`` on
    ``devices[i]``) on an int8 wire with error feedback.

    All pods agree on a shared scale (the max over pods); each quantizes
    (g + e) into int8 at a quantum of scale / (127 // n), so the exact
    sum of n payloads cannot overflow int8.  Returns (the mean tree on
    each pod's device, each pod's new error tree)."""
    n = len(devices)
    if len(grads) != n or (err is not None and len(err) != n):
        raise ValueError(f"{n} pods, {len(grads)} gradient trees, "
                         f"{'no' if err is None else len(err)} error trees")
    g_l = [[t for _, t in leaves_with_path(g)] for g in grads]
    if err is None:
        e_l = [[torch.zeros_like(upcast(t)) for t in gs] for gs in g_l]
    else:
        e_l = [[t for _, t in leaves_with_path(e)] for e in err]
    out = run_lockstep([_pod_body(g, e, n) for g, e in zip(g_l, e_l)],
                       list(devices), (tuple(range(n)),), devices[0])
    return ([unflatten(grads[i], m) for i, (m, _) in enumerate(out)],
            [unflatten(grads[i], e) for i, (_, e) in enumerate(out)])
