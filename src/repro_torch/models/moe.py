"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Dispatch algorithm (drop-on-overflow, deterministic):

  1. router scores -> top-k (gate, expert) per token;
  2. flatten the T*k assignments, stable-sort by expert id;
  3. position-within-expert via searchsorted (first-occurrence trick) --
     no (T, E) one-hots, no (T, E, C) dispatch tensors;
  4. scatter tokens into an (E, C, d) buffer, batched expert matmuls
     (one ``bmm`` per projection over the expert axis), gather back with
     gates.

Capacity C = ceil(T*k/E * capacity_factor); overflow tokens fall back to
the residual path (standard dropping semantics).  Every dropped
assignment is scattered into one spare row (the drop bin, index E*C),
which is thrown away; kept slots are unique, so no drop overwrites one.

The combine does not scatter-add (``index_add_`` adds with atomics on
CUDA, so a token's k contributions would sum in a varying order): the
contributions are put back in token-major order and each token's k of
them summed in top-k order, the same way on every run.

Arctic-style ``dense residual``: a small dense MLP runs in parallel with
the MoE and is summed (cfg.moe_dense_residual).

``observe(fn)`` is an instrumentation seam: inside it, every
``apply_moe`` call hands ``fn`` its ``Routing`` (expert ids and the kept
mask), for counting drops or comparing routings; outside it, nothing is
recorded.  Under ``RunSpec.remat == "block"`` with grad enabled, the
backward recomputes each block's forward, so ``fn`` sees each block's
routing a second time, during the backward.
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunSpec
from .layers import apply_mlp, bmm, mlp_defs, mm, upcast
from .module import ParamDef

_OBSERVERS: list[Callable] = []


def moe_defs(cfg: ModelConfig, rt: RunSpec) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    # the reference's 2D expert sharding axes: experts over 'model', the
    # expert FFN width over 'data' where it divides by 16
    ff_shard = "data" if f % 16 == 0 else None
    defs = {
        "router": ParamDef((d, e), (None, None)),
        "wi": ParamDef((e, d, f), ("model", None, ff_shard)),
        "wg": ParamDef((e, d, f), ("model", None, ff_shard)),
        "wo": ParamDef((e, f, d), ("model", ff_shard, None)),
    }
    if cfg.moe_dense_residual:
        defs["dense"] = mlp_defs(d, cfg.moe_dense_ff or cfg.d_ff, cfg.mlp)
    return defs


def capacity(cfg: ModelConfig, rt: RunSpec, n_tokens: int) -> int:
    cf = rt.capacity_factor or cfg.moe_capacity_factor
    c = int(n_tokens * cfg.moe_top_k / cfg.n_experts * cf)
    return max(8, -(-c // 8) * 8)     # pad to vector-lane multiple


class Routing(NamedTuple):
    """One call's dispatch, per stripe: ``eids`` (stripes, t_loc, k) the
    chosen experts in top-k order; ``order`` (stripes, t_loc*k) the
    stable sort of the flat assignments by expert; ``slot`` the buffer
    row of each sorted assignment (E*C, the drop bin, where dropped);
    ``gate`` the sorted renormalised gates; ``keep`` the sorted kept
    mask."""

    eids: torch.Tensor
    order: torch.Tensor
    slot: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor


@contextlib.contextmanager
def observe(fn: Callable[[Routing], None]):
    """Call ``fn(routing)`` from every ``apply_moe`` inside the block
    (again for each recomputed block of a remat backward)."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def route(p, xt: torch.Tensor, cfg: ModelConfig, c: int) -> Routing:
    """xt (stripes, t_loc, d) -> the stripe-local ``Routing``."""
    n_s, t_loc, _ = xt.shape
    k, e = cfg.moe_top_k, cfg.n_experts
    dev = xt.device
    scores = torch.softmax(upcast(mm(xt, p["router"])), dim=-1)
    gates, eids = torch.topk(scores, k, dim=-1)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    flat_e = eids.reshape(n_s, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_gate = torch.gather(gates.reshape(n_s, -1).to(xt.dtype), 1,
                               order)
    # position within expert group = rank - first-occurrence rank
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(t_loc * k, device=dev) - first
    keep = pos < c
    slot = torch.where(keep, sorted_e * c + pos, e * c)   # drop bin e*c
    return Routing(eids, order, slot, sorted_gate, keep)


def apply_moe(p, x, cfg: ModelConfig, rt: RunSpec):
    """x (B,S,d) -> (B,S,d).

    Stripe-local dispatch, as the reference's: the token axis is viewed
    as ``rt.dp`` contiguous stripes (when the batch divides), and
    routing, sort, scatter and combine run within each stripe.
    """
    b, s, d = x.shape
    t = b * s
    k, e = cfg.moe_top_k, cfg.n_experts
    stripes = rt.dp if (rt.dp > 1 and b % rt.dp == 0) else 1
    t_loc = t // stripes
    c = capacity(cfg, rt, t_loc)
    xt = x.reshape(stripes, t_loc, d)
    r = route(p, xt, cfg, c)
    for fn in _OBSERVERS:
        fn(r)

    # scatter: each stripe owns e*c + 1 rows, its last one the drop bin
    rows = e * c + 1
    base = (torch.arange(stripes, device=x.device) * rows)[:, None]
    sorted_tok = torch.div(r.order, k, rounding_mode="floor")
    src = torch.gather(xt, 1, sorted_tok[..., None].expand(-1, -1, d))
    buf = x.new_zeros((stripes * rows, d))
    buf.index_copy_(0, (r.slot + base).reshape(-1), src.reshape(-1, d))
    eb = buf.view(stripes, rows, d)[:, : e * c].reshape(stripes, e, c, d)

    # expert matmuls: (E, stripes*C, d) @ (E, d, f) per projection
    eb = eb.transpose(0, 1).reshape(e, stripes * c, d)
    h = F.silu(bmm(eb, p["wg"])) * bmm(eb, p["wi"])
    out_e = bmm(h, p["wo"])                        # (E, stripes*C, d)
    flat = out_e.reshape(e, stripes, c, d).transpose(0, 1).reshape(
        stripes, e * c, d)

    # gather back with gates, then put the contributions in token-major
    # (top-k) order and sum each token's k of them in that order
    idx = torch.clamp(r.slot, max=e * c - 1)
    g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, d))
    g = torch.where(r.keep[..., None], g, 0.0) * r.gate[..., None]
    contrib = torch.empty_like(g)
    contrib.scatter_(1, r.order[..., None].expand(-1, -1, d), g)
    contrib = contrib.view(stripes, t_loc, k, d)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    out = out.reshape(b, s, d)

    if "dense" in p:
        out = out + apply_mlp(p["dense"], x, cfg.mlp)
    return out


def aux_load_loss(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over tokens)."""
    t = x.shape[0] * x.shape[1]
    scores = torch.softmax(upcast(mm(x.reshape(t, -1), p["router"])),
                           dim=-1)
    _, eids = torch.topk(scores, cfg.moe_top_k, dim=-1)
    onehot = F.one_hot(eids, cfg.n_experts).to(scores.dtype)
    frac_tokens = torch.mean(torch.sum(onehot, dim=1), dim=0)
    frac_probs = torch.mean(scores, dim=0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
