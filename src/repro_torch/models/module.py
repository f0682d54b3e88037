"""Declarative parameter system.

Every model describes its parameters once, as a nested dict of
``ParamDef`` (shape + partition axes + initializer).  From that single
description we derive:

  * ``abstract(defs)``   -- tensors on the ``meta`` device (NO allocation;
    this is how a full-width config is sized on any host);
  * ``init(defs)``       -- real parameters, on the card by default;
  * ``from_numpy(defs, arrays)`` -- the same tree built from numpy arrays
    (for example the reference package's parameters), checked leaf by
    leaf against the defs;
  * ``pspecs(defs)``     -- the partition axes of each leaf, as plain
    tuples (``tuple()`` of the reference's ``PartitionSpec``s);
  * ``count_params(defs)``.

Layer stacks are expressed with ``stack(defs, n)``, which prepends a
layer axis; the blocks loop over it.

``init`` seeds each leaf from a stable digest (``zlib.crc32``) of its
tree path, so the weights do not depend on traversal order, on the
process, or on ``PYTHONHASHSEED``.  The same seed gives the same
weights on one device type; the CPU and the CUDA generators are
different algorithms, so a seed gives other weights on the card than on
the CPU (move a CPU tree with ``.to`` where both must agree).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    pspec: tuple = ()           # mesh axis name (or None) per dimension
    init: str = "normal"        # normal | zeros | ones
    scale: float | None = None  # stddev override (default fan-in)
    dtype: torch.dtype = torch.float32

    def with_stack(self, n: int) -> "ParamDef":
        return dataclasses.replace(
            self, shape=(n, *self.shape), pspec=(None, *self.pspec))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/tuples (and any
    parallel trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_path(tree, prefix: str = ""):
    """``[(path, leaf)]`` with ``/``-joined paths, dict keys sorted as the
    reference's tree flattening sorts them."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, t in enumerate(tree):
            out += leaves_with_path(t, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in
    ``leaves_with_path`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def stack(defs, n: int):
    """Prepend a layer axis of size n to every ParamDef."""
    return tree_map(lambda d: d.with_stack(n), defs)


def abstract(defs, dtype: torch.dtype | None = None):
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype or d.dtype,
                                          device="meta"), defs)


def pspecs(defs):
    return tree_map(lambda d: d.pspec, defs)


def leaf_seed(base: int, path: str) -> int:
    """The per-leaf seed: ``base`` and a crc32 digest of the tree path."""
    return (base * 0x9E3779B1 + zlib.crc32(path.encode())) % (2 ** 63)


def init(defs, *, device: str | torch.device = "cuda",
         generator: int | torch.Generator | None = None,
         dtype: torch.dtype | None = None):
    """Initialize real parameters on ``device`` (the card by default; no
    CPU fallback).  ``generator`` is a seed, or a ``torch.Generator``
    whose ``initial_seed()`` is the seed (default 0); each leaf draws
    from its own generator seeded by ``leaf_seed``."""
    dev = resolve_device(device)
    if isinstance(generator, torch.Generator):
        base = generator.initial_seed()
    else:
        base = int(generator or 0)

    def make(path, d):
        dt = dtype or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        g = torch.Generator(device=dev).manual_seed(leaf_seed(base, path))
        w = torch.randn(d.shape, generator=g, dtype=torch.float32,
                        device=dev)
        return (w * std).to(dt)

    return _build(defs, make)


def from_numpy(defs, arrays, device: str | torch.device = "cuda"):
    """The parameter tree from nested dicts of numpy arrays with the
    defs' structure (e.g. ``jax.tree.map(np.asarray, params)`` of the
    reference).  Every path and shape must match the defs."""
    dev = resolve_device(device)
    want = dict(leaves_with_path(defs))
    got = dict(leaves_with_path(arrays))
    if want.keys() != got.keys():
        raise ValueError(
            f"parameter paths differ: missing {sorted(want.keys() - got)}, "
            f"unexpected {sorted(got.keys() - want)}")

    def make(path, d):
        a = np.asarray(got[path])
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {tuple(a.shape)} where the "
                             f"defs give {tuple(d.shape)}")
        return torch.tensor(a, dtype=d.dtype, device=dev)

    return _build(defs, make)


def _build(defs, make: Callable[[str, ParamDef], Any], prefix: str = ""):
    if isinstance(defs, dict):
        return {k: _build(v, make, f"{prefix}{k}/") for k, v in defs.items()}
    return make(prefix[:-1], defs)


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for _, d in leaves_with_path(defs)))
