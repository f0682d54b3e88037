"""AdamW with mixed precision and ZeRO-1 state layout.

State layout (all trees matching the param tree):
  master -- float32 master weights
  m, v   -- float32 moments
The compute params are re-materialized from master each step
(``train.step``).

ZeRO-1: the reference shards the optimizer state over the *data* axes in
addition to the param's own model sharding; ``zero1_spec`` picks the
first axis that is unsharded and divisible by the data-axis size.  The
port runs the update on one device and keeps the specs (plain axis
tuples) so that ``train.step.abstract_train_state`` describes the same
layout as the reference's.

The update runs in at least float32 (``upcast``): float32 as in the
reference, float64 for a float64 state.  Leaves are taken in
``module.leaves_with_path`` order, the reference's flatten order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import upcast
from repro_torch.models.module import (ParamDef, leaves_with_path, tree_map,
                                       unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    lr_min: float = 3e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(c: AdamWConfig, step, dtype: torch.dtype = torch.float32):
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min`` at
    ``total_steps``; computed in ``dtype`` on ``step``'s device."""
    step = torch.as_tensor(step).to(dtype)
    warm = c.lr_peak * torch.clamp(step / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps)
                    / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.lr_min + 0.5 * (c.lr_peak - c.lr_min) * (1 + torch.cos(math.pi
                                                                   * t))
    return torch.where(step < c.warmup_steps, warm, cos)


def zero1_spec(d: ParamDef, data_axes: tuple[str, ...],
               data_size: int) -> tuple:
    """Additionally shard the first unsharded, divisible axis over data."""
    parts = list(d.pspec) + [None] * (len(d.shape) - len(d.pspec))
    used = set()
    for part in parts:
        for a in (part if isinstance(part, (tuple, list)) else (part,)):
            used.add(a)
    if used & set(data_axes):
        return d.pspec         # already data-sharded (e.g. 2D MoE experts)
    for i, (dim, part) in enumerate(zip(d.shape, parts)):
        if part is None and dim % data_size == 0 and dim >= data_size:
            parts[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return tuple(parts)
    return d.pspec


def opt_defs(param_defs, data_axes=("data",), data_size: int = 1):
    """ParamDefs for (master, m, v) with ZeRO-1 partition axes."""
    z = tree_map(lambda d: dataclasses.replace(
        d, pspec=zero1_spec(d, data_axes, data_size), dtype=torch.float32),
        param_defs)
    zeros = tree_map(lambda d: dataclasses.replace(d, init="zeros"), z)
    return {"master": z, "m": zeros, "v": zeros}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(upcast(g)))
                          for _, g in leaves_with_path(tree)))


def apply_update(c: AdamWConfig, state, grads, step):
    """state = {master, m, v}; ``grads`` a tree of the master's structure
    (any float dtype); ``step`` the 0-d step counter.  Returns
    (new_state, {"grad_norm", "lr"}); ``state`` is not modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    mst_l = [t for _, t in leaves_with_path(state["master"])]
    lr = schedule(c, step, mst_l[0].dtype).to(mst_l[0].device)
    t = torch.as_tensor(step).to(lr) + 1.0
    b1, b2 = c.b1, c.b2

    def upd(mst, m, v, g):
        g = upcast(g) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        mst = mst - lr * (mh / (torch.sqrt(vh) + c.eps)
                          + c.weight_decay * mst)
        return mst, m, v

    outs = [upd(*a) for a in zip(
        mst_l, *([t for _, t in leaves_with_path(state[k])]
                 for k in ("m", "v")),
        [g for _, g in leaves_with_path(grads)])]
    new = {k: unflatten(state[k], [o[i] for o in outs])
           for i, k in enumerate(("master", "m", "v"))}
    return new, {"grad_norm": gnorm, "lr": lr}
