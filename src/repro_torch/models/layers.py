"""Shared layers: norms, MLPs, RoPE, embeddings.

Param-def builders return nested dicts of ParamDef whose partition axes
follow the Megatron mapping on a ('data', 'model') mesh (embeddings:
vocab over 'model'; MLP in-proj ff over 'model', out-proj row-parallel;
norm scales replicated).  The port runs on one device; the axes are
kept so the defs read the same as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import ParamDef


def upcast(x):
    """At least float32: lower precisions compute in float32 (the
    reference's ``astype(float32)``); float64 stays float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ----------------------------------------------------------------- norms
def norm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), (), init="ones"),
            "bias": ParamDef((d,), (), init="zeros")}


def apply_norm(p, x, kind: str, eps: float = 1e-5):
    """RMSNorm or LayerNorm, computed in at least f32 and cast back."""
    xf = upcast(x)
    if kind == "rmsnorm":
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * r * p["scale"]
    else:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def gelu(x):
    """The tanh form: ``jax.nn.gelu``'s default, not torch's."""
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ MLPs
def mlp_defs(d: int, ff: int, kind: str, bias: bool = False) -> dict:
    defs = {}
    if kind == "swiglu":
        defs["wi"] = ParamDef((d, ff), (None, "model"))
        defs["wg"] = ParamDef((d, ff), (None, "model"))
    else:
        defs["wi"] = ParamDef((d, ff), (None, "model"))
    defs["wo"] = ParamDef((ff, d), ("model", None))
    if bias:
        defs["bi"] = ParamDef((ff,), ("model",), init="zeros")
        defs["bo"] = ParamDef((d,), (), init="zeros")
    return defs


def apply_mlp(p, x, kind: str):
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = x @ p["wi"]
        if "bi" in p:
            h = h + p["bi"]
        h = gelu(h)
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# ------------------------------------------------------------------ RoPE
def rope_angles(positions: torch.Tensor, dim: int, theta: float,
                dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim/2), computed in ``dtype``:
    float32 as in the reference, float64 for a float64 evaluation."""
    exp = torch.arange(0, dim, 2, dtype=dtype, device=positions.device) / dim
    inv = 1.0 / (float(theta) ** exp)
    ang = positions[..., None].to(dtype) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, dim) with cos/sin (..., S, dim/2) (broadcast over H).
    Rotates the two split halves, not interleaved pairs."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1
                     ).to(x.dtype)


# ------------------------------------------------------------ embeddings
def embed_defs(vocab: int, d: int) -> dict:
    return {"table": ParamDef((vocab, d), ("model", None), scale=1.0)}


def apply_embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def lm_head_defs(vocab: int, d: int) -> dict:
    return {"w": ParamDef((d, vocab), (None, "model"))}


def apply_lm_head(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
