"""Mamba2 -- SSD (state-space duality) blocks, chunked matmul form.

The sequence is split into chunks of Q tokens; *within* a chunk the
recurrence is expanded into a masked (Q x Q) matmul, *between* chunks a
small (nh, ds, hd) state is carried by a loop over the chunks:

  * train/prefill: chunked SSD, the inter-chunk scan a loop that emits
    the state before each chunk;
  * decode: O(1) single-token state update (the "cache" is a fixed-size
    state, so a decode step costs the same after any prompt length).

Conv: depthwise causal width-4 over the (x, B, C) channels, expressed as
4 shifted elementwise FMAs (no conv op needed).

The SSM state is (B, nh, ds, hd) throughout (``init_cache``, the
carried state and the chunk states).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunSpec
from .attention import _proj
from .layers import einsum, mm, upcast
from .module import ParamDef


def mamba_defs(cfg: ModelConfig, rt: RunSpec) -> dict:
    d = cfg.d_model
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    conv = cfg.ssm_conv
    return {
        "wz": ParamDef((d, nh, hd), (None, "model", None)),
        "wx": ParamDef((d, nh, hd), (None, "model", None)),
        "wB": ParamDef((d, ds), (None, None)),
        "wC": ParamDef((d, ds), (None, None)),
        "wdt": ParamDef((d, nh), (None, "model")),
        "dt_bias": ParamDef((nh,), ("model",), init="zeros"),
        "A_log": ParamDef((nh,), ("model",), init="zeros"),
        "D": ParamDef((nh,), ("model",), init="ones"),
        "conv_x": ParamDef((conv, nh, hd), (None, "model", None),
                           scale=0.5),
        "conv_B": ParamDef((conv, ds), (None, None), scale=0.5),
        "conv_C": ParamDef((conv, ds), (None, None), scale=0.5),
        "norm": ParamDef((nh, hd), ("model", None), init="ones"),
        "wo": ParamDef((nh, hd, d), ("model", None, None)),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv via shifted adds.

    x (B,S,...), w (conv, ...) broadcasting over trailing dims.
    state (B, conv-1, ...) holds the last tokens of the previous segment.
    Returns (y, new_state)."""
    conv = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], conv - 1, *x.shape[2:]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[conv - 1]
    for i in range(1, conv):
        y = y + xp[:, i:i + s] * w[conv - 1 - i]
    new_state = xp[:, xp.shape[1] - (conv - 1):]
    return F.silu(y), new_state


def _gated_norm(y, z, scale, eps=1e-5):
    g = y * F.silu(z)
    gf = upcast(g)
    r = torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + eps)
    return (gf * r * scale).to(y.dtype)


def _inputs(p, xin):
    """The projections shared by the chunked and the recurrent forms."""
    z = _proj(xin, p["wz"])
    x = _proj(xin, p["wx"])
    bb = mm(xin, p["wB"])
    cc = mm(xin, p["wC"])
    dt = F.softplus(mm(xin, p["wdt"]) + p["dt_bias"])          # (B,S,nh)
    return z, x, bb, cc, dt


def ssd_chunked(a, xbar, bb, cc, q: int, st0=None):
    """The chunked SSD scan: a (B,S,nh) per-step log-decays (<= 0), xbar
    (B,S,nh,hd) dt-scaled inputs, bb/cc (B,S,ds), chunk length q, st0
    (B,nh,ds,hd) or None (zeros).  Returns (y (B,S,nh,hd), the state
    after the last step (B,nh,ds,hd))."""
    b, s, nh = a.shape
    hd, ds = xbar.shape[-1], bb.shape[-1]
    s_pad = -(-s // q) * q                # pad to a chunk multiple
    nc = s_pad // q
    if s_pad != s:
        # pad tail: a=0 (no state decay), xbar=0 (no state input) so the
        # carried-out state is exact; padded outputs are sliced off below.
        pad = s_pad - s
        a = F.pad(a, (0, 0, 0, pad))
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))

    # chunk views
    ar = a.reshape(b, nc, q, nh)
    cum = torch.cumsum(ar, dim=2)                             # within-chunk
    xr = xbar.reshape(b, nc, q, nh, hd)
    br = bb.reshape(b, nc, q, ds)
    cr = cc.reshape(b, nc, q, ds)

    # ---- intra-chunk: masked (Q x Q) matmuls (the "duality") ----
    g = einsum("bcid,bcjd->bcij", cr, br)               # (B,nc,Q,Q)
    li = cum[:, :, :, None, :]                                # i decay
    lj = cum[:, :, None, :, :]                                # j decay
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    # exp above the diagonal may overflow to inf; where() discards it
    # (a multiply by the mask would turn inf * 0 into NaN)
    decay = torch.where(mask[None, None, :, :, None], torch.exp(li - lj),
                        0.0)                                  # (B,nc,Q,Q,nh)
    m = g[..., None] * decay
    y_intra = einsum("bcijh,bcjhe->bcihe", m, xr)

    # ---- chunk states and inter-chunk scan ----
    tail = cum[:, :, -1:, :]                                  # (B,nc,1,nh)
    sdecay = torch.exp(tail - cum)                            # decay to end
    # (B,nc,Q,ds) x (B,nc,Q,nh) x (B,nc,Q,nh,hd) -> (B,nc,nh,ds,hd)
    s_c = upcast(einsum("bcjd,bcjh,bcjhe->bchde", br, sdecay, xr))
    chunk_a = torch.exp(tail[:, :, 0, :])                     # (B,nc,nh)

    h = (upcast(st0) if st0 is not None
         else torch.zeros((b, nh, ds, hd), dtype=upcast(a).dtype,
                          device=a.device))
    h_pre = []
    for ci in range(nc):                  # emit the state BEFORE chunk ci
        h_pre.append(h)
        h = h * chunk_a[:, ci, :, None, None] + s_c[:, ci]
    h_pre = torch.stack(h_pre, dim=1)                         # (B,nc,nh,ds,hd)

    y_inter = einsum("bcid,bcih,bchde->bcihe",
                     cr, torch.exp(cum), h_pre.to(cr.dtype))
    return (y_intra + y_inter).reshape(b, s_pad, nh, hd)[:, :s], h


def apply_mamba(p, xin, cfg: ModelConfig, rt: RunSpec, cache=None):
    """xin (B,S,d) -> (out (B,S,d), cache').

    cache = (ssm_state (B,nh,ds,hd), conv_states) carried across segments
    (prefill -> decode).  Training passes cache=None.
    """
    s = xin.shape[1]
    z, x, bb, cc, dt = _inputs(p, xin)
    st0 = None
    cstates = (None, None, None)
    if cache is not None:
        st0, cstates = cache
    x, cx = _causal_conv(x, p["conv_x"], cstates[0])
    bb, cb = _causal_conv(bb, p["conv_B"], cstates[1])
    cc, ccs = _causal_conv(cc, p["conv_C"], cstates[2])

    a = dt * (-torch.exp(upcast(p["A_log"])))                # (B,S,nh) <=0
    xbar = x * dt[..., None]                                  # dt-scaled input
    y, h = ssd_chunked(a, xbar, bb, cc, min(cfg.ssm_chunk, s), st0)
    y = y + x * p["D"][:, None]
    y = _gated_norm(y, z, p["norm"])
    out = einsum("bshe,hed->bsd", y, p["wo"]).to(xin.dtype)
    return out, (h, (cx, cb, ccs))


def mamba_decode(p, xin, cache, cfg: ModelConfig, rt: RunSpec):
    """Single-token step: xin (B,1,d); cache from apply_mamba/init_cache.
    Returns (out (B,1,d), new cache)."""
    st, cstates = cache
    z, x, bb, cc, dt = _inputs(p, xin)
    x, cx = _causal_conv(x, p["conv_x"], cstates[0])
    bb, cb = _causal_conv(bb, p["conv_B"], cstates[1])
    cc, ccs = _causal_conv(cc, p["conv_C"], cstates[2])

    a = torch.exp(dt[:, 0] * (-torch.exp(upcast(p["A_log"]))))
    xbar = (x * dt[..., None])[:, 0]                          # (B,nh,hd)
    st = upcast(st) * a[..., None, None] \
        + einsum("bd,bhe->bhde", upcast(bb[:, 0]), upcast(xbar))
    y = einsum("bd,bhde->bhe", cc[:, 0], st.to(cc.dtype))
    y = y + x[:, 0] * p["D"][:, None]
    y = _gated_norm(y[:, None], z, p["norm"])[:, 0]
    out = einsum("bhe,hed->bd", y, p["wo"])[:, None].to(xin.dtype)
    return out, (st, (cx, cb, ccs))


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
               device="cpu"):
    nh, hd, ds, conv = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                        cfg.ssm_conv)
    st = torch.zeros((batch, nh, ds, hd),
                     dtype=torch.promote_types(dtype, torch.float32),
                     device=device)
    cx = torch.zeros((batch, conv - 1, nh, hd), dtype=dtype, device=device)
    cb = torch.zeros((batch, conv - 1, ds), dtype=dtype, device=device)
    cc = torch.zeros((batch, conv - 1, ds), dtype=dtype, device=device)
    return st, (cx, cb, cc)
