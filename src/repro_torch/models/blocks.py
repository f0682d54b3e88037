"""Transformer blocks and layer stacks.

A stack's parameters carry a leading layer axis (``module.stack``); the
reference scans over it with ``lax.scan``, the port loops over the layer
index.  ``RunSpec.remat`` (checkpoint each scanned block) is a training
knob and is ignored on this serving path.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunSpec
from . import attention
from .layers import apply_mlp, apply_norm, mlp_defs, norm_defs, upcast
from .module import stack, tree_map

NEXT_SLICE = "ROADMAP A9b"


# ------------------------------------------------------------ attn block
def block_defs(cfg: ModelConfig, rt: RunSpec, cross: bool = False) -> dict:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE feed-forward (models/moe.py) is not "
            f"ported yet ({NEXT_SLICE})")
    d = cfg.d_model
    defs = {"norm1": norm_defs(d), "norm2": norm_defs(d),
            "attn": attention.attn_defs(cfg, rt)}
    if cross:
        defs["norm_x"] = norm_defs(d)
        defs["xattn"] = attention.attn_defs(cfg, rt, cross=True)
    defs["ffn"] = mlp_defs(d, cfg.d_ff, cfg.mlp, cfg.mlp_bias)
    return defs


def apply_block(p, x, cfg: ModelConfig, rt: RunSpec, *, positions,
                causal=True, enc_out=None):
    """Full-sequence block (train/prefill). Returns (x, cache)."""
    rs = cfg.residual_scale
    h = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.mla:
        a, cache = attention.apply_mla(p["attn"], h, cfg, rt,
                                       positions=positions)
    else:
        a, cache = attention.apply_attn(p["attn"], h, cfg, rt,
                                        positions=positions, causal=causal)
    x = x + a * rs
    if enc_out is not None:
        h = apply_norm(p["norm_x"], x, cfg.norm)
        a, xcache = attention.apply_attn(p["xattn"], h, cfg, rt,
                                         positions=None, causal=False,
                                         kv_x=enc_out)
        x = x + a * rs
        cache = (cache, xcache)
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["ffn"], h, cfg.mlp) * rs, cache


def apply_block_decode(p, x, cache, pos, cfg: ModelConfig, rt: RunSpec, *,
                       mesh=None, seq_axis="model"):
    """One-token block step against the cache (written in place).
    Returns (x, cache)."""
    rs = cfg.residual_scale
    xcache = None
    if isinstance(cache, tuple) and len(cache) == 2 \
            and isinstance(cache[0], tuple):
        cache, xcache = cache          # (self, cross)
    h = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.mla:
        a, cache = attention.mla_decode(p["attn"], h, cache, pos, cfg, rt,
                                        mesh=mesh, seq_axis=seq_axis)
    else:
        a, cache = attention.decode_attn(p["attn"], h, cache, pos, cfg, rt,
                                         mesh=mesh, seq_axis=seq_axis)
    x = x + a * rs
    if xcache is not None:
        h = apply_norm(p["norm_x"], x, cfg.norm)
        k, v = xcache                  # static encoder kv: plain attention
        ke = attention._expand_kv(k, cfg, RunSpec(tp=1), 1)
        ve = attention._expand_kv(v, cfg, RunSpec(tp=1), 1)
        q = attention._proj(h, p["xattn"]["wq"])[:, :, : cfg.n_heads]
        sc = torch.einsum("bshe,bhte->bhst", q * (cfg.hd ** -0.5),
                          ke.to(q.dtype))
        pr = torch.softmax(upcast(sc), dim=-1).to(q.dtype)
        o = torch.einsum("bhst,bhte->bshe", pr, ve.to(q.dtype))
        a = attention._out(o, p["xattn"]["wo"][: cfg.n_heads])
        x = x + a * rs
        cache = (cache, xcache)
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["ffn"], h, cfg.mlp) * rs, cache


# ------------------------------------------------------------- stacks
def stack_defs(cfg: ModelConfig, rt: RunSpec, n: int,
               cross: bool = False) -> dict:
    return stack(block_defs(cfg, rt, cross=cross), n)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    return tree_map(lambda a: a[i], tree)


def apply_stack(params, x, cfg: ModelConfig, rt: RunSpec, *, positions,
                causal=True, enc_out=None, collect_cache=False):
    """Loop over a stacked block tree; optionally stack per-layer caches
    along a new leading layer axis."""
    n = next(iter(params["norm1"].values())).shape[0]
    caches = []
    for i in range(n):
        x, cache = apply_block(layer(params, i), x, cfg, rt,
                               positions=positions, causal=causal,
                               enc_out=enc_out)
        if collect_cache:
            caches.append(cache)
    if not collect_cache:
        return x, None
    return x, tree_map(lambda *c: torch.stack(c), *caches)


def apply_stack_decode(params, x, caches, pos, cfg: ModelConfig,
                       rt: RunSpec, *, mesh=None, seq_axis="model"):
    """One token through every layer; each layer's cache slot is written
    in place, so the stacked caches come back updated."""
    n = next(iter(params["norm1"].values())).shape[0]
    for i in range(n):
        x, _ = apply_block_decode(layer(params, i), x, layer(caches, i),
                                  pos, cfg, rt, mesh=mesh,
                                  seq_axis=seq_axis)
    return x, caches
