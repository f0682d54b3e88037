"""Attention: GQA/MHA/MLA, memory-efficient prefill, flash-decode.

* train / prefill -- q heads are zero-padded to a multiple of ``rt.tp``
  (``RunSpec.padded_heads``) and GQA kv heads are expanded to the q-head
  count by an exact gather (``kv_map``: k/v for q head h come from
  logical kv head h // group; pad heads read kv head 0).

* decode -- the KV cache keeps LOGICAL kv heads, (B, KV, S_max, hd), and
  one new token attends over it with the (max, sum, weighted-value)
  flash-decode reduction.  The reference shards the cache's sequence
  axis over a mesh (``mesh=``); the port serves on one device, and
  ``mesh=`` raises (ROADMAP A9b).

Memory-efficient prefill attention scans over KV chunks with an online
softmax, so peak score memory is (S_q * chunk), never (S_q * S_kv).  The
port computes this softmax itself, branch for branch as the reference
does, rather than calling ``scaled_dot_product_attention``.

The decode cache is written in place: one (B, KV, 1, hd) slot per step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, RunSpec
from .layers import apply_rope, rope_angles, upcast
from .module import ParamDef

NEG_INF = -1e30
_NO_MESH = ("the sequence-sharded decode over a mesh is not ported; the "
            "port serves on one device (ROADMAP A9b)")


# ---------------------------------------------------------------- params
def attn_defs(cfg: ModelConfig, rt: RunSpec, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.hd
    hp = rt.padded_heads(cfg.n_heads)
    if cfg.mla and not cross:
        rope, nope, vd = cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
        return {
            "wq_a": ParamDef((d, cfg.q_lora_rank), (None, None)),
            "q_norm": ParamDef((cfg.q_lora_rank,), (), init="ones"),
            "wq_b": ParamDef((cfg.q_lora_rank, hp, nope + rope),
                             (None, "model", None)),
            "wkv_a": ParamDef((d, cfg.kv_lora_rank + rope), (None, None)),
            "kv_norm": ParamDef((cfg.kv_lora_rank,), (), init="ones"),
            "wkv_b": ParamDef((cfg.kv_lora_rank, hp, nope + vd),
                              (None, "model", None)),
            "wo": ParamDef((hp, vd, d), ("model", None, None)),
        }
    kv_shard = "model" if cfg.n_kv_heads % max(rt.tp, 1) == 0 else None
    defs = {
        "wq": ParamDef((d, hp, hd), (None, "model", None)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), (None, kv_shard, None)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), (None, kv_shard, None)),
        "wo": ParamDef((hp, hd, d), ("model", None, None)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((hp, hd), ("model", None), init="zeros")
        defs["bk"] = ParamDef((cfg.n_kv_heads, hd), (kv_shard, None),
                              init="zeros")
        defs["bv"] = ParamDef((cfg.n_kv_heads, hd), (kv_shard, None),
                              init="zeros")
    if cfg.attn_out_bias:
        defs["bo"] = ParamDef((d,), (), init="zeros")
    if cfg.qk_norm:
        defs["qn"] = ParamDef((hd,), (), init="ones")
        defs["kn"] = ParamDef((hd,), (), init="ones")
    return defs


def kv_map(cfg: ModelConfig, rt: RunSpec, device="cpu") -> torch.Tensor:
    """Logical kv head for each padded q head (pad heads -> kv 0).  Built
    with device ops, so no host-to-device copy waits on the stream."""
    hp = rt.padded_heads(cfg.n_heads)
    group = cfg.n_heads // cfg.n_kv_heads
    h = torch.arange(hp, device=device)
    m = torch.clamp(h // group, max=cfg.n_kv_heads - 1)
    return torch.where(h < cfg.n_heads, m, torch.zeros_like(m))


def _expand_kv(x, cfg: ModelConfig, rt: RunSpec, dim: int):
    """``take(x, kv_map, axis=dim)``; the identity when nothing maps."""
    if rt.padded_heads(cfg.n_heads) == cfg.n_heads == cfg.n_kv_heads:
        return x
    return torch.index_select(x, dim, kv_map(cfg, rt, x.device))


def _rms(x, scale, eps=1e-5):
    xf = upcast(x)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * scale).to(x.dtype)


def _proj(x, w):
    """einsum('...d,dhe->...he') as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out(o, wo):
    """einsum('...he,hed->...d') as one matmul."""
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


# ----------------------------------------------- chunked online-softmax
def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      chunk: int = 1024, scale: float | None = None):
    """q (B,S,H,D); k,v (B,T,H,D) -> (B,S,H,D); O(S*chunk) score memory."""
    b, s, h, d = q.shape
    t = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = upcast(q) * scale
    qpos = torch.arange(s, device=dev)[:, None] + q_offset

    if t <= max(chunk, 2048):  # small kv: one shot
        sc = torch.einsum("bshd,bthd->bhst", qf, upcast(k))
        if causal:
            sc = torch.where(qpos >= torch.arange(t, device=dev)[None, :],
                             sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        return torch.einsum("bhst,bthd->bshd", p, upcast(v)).to(q.dtype)

    n = -(-t // chunk)
    pad = n * chunk - t
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, h, s), NEG_INF, dtype=qf.dtype, device=dev)
    l = torch.zeros((b, h, s), dtype=qf.dtype, device=dev)
    o = torch.zeros((b, h, s, d), dtype=qf.dtype, device=dev)
    for ci in range(n):
        kc = kp[:, ci * chunk:(ci + 1) * chunk]
        vc = vp[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        sc = torch.einsum("bshd,bthd->bhst", qf, upcast(kc))
        valid = kpos[None, :] < t
        if causal:
            valid = valid & (qpos >= kpos[None, :])
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhst,bthd->bhsd", p,
                                                upcast(vc))
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)      # (B,S,H,D)


# --------------------------------------------------- GQA train / prefill
def apply_attn(p, x, cfg: ModelConfig, rt: RunSpec, *,
               positions, causal: bool = True, kv_x=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    Returns (out, (k_cache, v_cache)) -- caches in LOGICAL kv heads,
    (B, KV, S_kv, hd), for the decode path.
    """
    kv_x = x if kv_x is None else kv_x
    q = _proj(x, p["wq"])
    k = _proj(kv_x, p["wk"])
    v = _proj(kv_x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if "qn" in p:
        q = _rms(q, p["qn"])
        k = _rms(k, p["kn"])
    if positions is not None:   # rope (not used for cross attention)
        cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta,
                               upcast(q).dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    ke = _expand_kv(k, cfg, rt, 2)      # exact GQA -> MHA expansion
    ve = _expand_kv(v, cfg, rt, 2)
    out = chunked_attention(q, ke, ve, causal=causal, chunk=rt.attn_chunk)
    out = _out(out, p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out, (k.transpose(1, 2), v.transpose(1, 2))   # (B,KV,S,hd)


# ------------------------------------------------------ flash decode
def _write_slot(buf, new, pos: int, s_loc: int, shard_idx: int = 0):
    """Write ``new`` (B, KV, D) into slot ``pos`` of ``buf`` (B, KV, S, D)
    in place; a slot outside this shard's [0, s_loc) writes nothing."""
    local_pos = pos - shard_idx * s_loc
    if 0 <= local_pos < s_loc:
        buf[:, :, local_pos] = new.to(buf.dtype)


def flash_decode_local(q, k, v, new_k, new_v, pos, shard_idx, s_loc,
                       *, axis=None, kmap=None, scale):
    """Decode attention over one cache slice.

    q (B,H,hd); k,v (B,KV,S_loc,hd), updated in place; new_k/new_v
    (B,KV,hd); pos int; kmap (H,) kv head per q head, or None for the
    identity.  Returns (out (B,H,hd), k, v).
    """
    if axis is not None:
        raise NotImplementedError(_NO_MESH)
    pos = int(pos)
    _write_slot(k, new_k, pos, s_loc, shard_idx)
    _write_slot(v, new_v, pos, s_loc, shard_idx)

    kq = k if kmap is None else torch.index_select(k, 1, kmap)
    vq = v if kmap is None else torch.index_select(v, 1, kmap)
    sc = torch.einsum("bhd,bhsd->bhs", upcast(q) * scale, upcast(kq))
    spos = shard_idx * s_loc + torch.arange(s_loc, device=q.device)
    sc = torch.where(spos[None, None, :] <= pos, sc, NEG_INF)
    m = torch.amax(sc, dim=-1)
    pexp = torch.exp(sc - m[..., None])
    l = torch.sum(pexp, dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", pexp, upcast(vq))
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, k, v


def decode_attn(p, x, cache, pos, cfg: ModelConfig, rt: RunSpec, *,
                mesh=None, seq_axis: str = "model"):
    """One-token decode against a logical-KV cache.

    x (B,1,d); cache (k,v) each (B,KV,S_max,hd), written in place.
    pos: int current position.  Returns (out (B,1,d), cache).
    """
    if mesh is not None and seq_axis is not None:
        raise NotImplementedError(_NO_MESH)
    hd = cfg.hd
    q = _proj(x, p["wq"])
    k_new = _proj(x, p["wk"])
    v_new = _proj(x, p["wv"])
    if "bq" in p:
        q, k_new, v_new = q + p["bq"], k_new + p["bk"], v_new + p["bv"]
    if "qn" in p:
        q = _rms(q, p["qn"])
        k_new = _rms(k_new, p["kn"])
    posv = torch.full((x.shape[0], 1), int(pos), device=x.device)
    cos, sin = rope_angles(posv, hd, cfg.rope_theta, upcast(q).dtype)
    q = apply_rope(q, cos, sin)
    k_new = apply_rope(k_new, cos, sin)
    q = q[:, 0, : cfg.n_heads]           # (B,H,hd) -- logical heads only
    k_new, v_new = k_new[:, 0], v_new[:, 0]

    one = RunSpec(tp=1)
    kmap = (None if cfg.n_heads == cfg.n_kv_heads
            else kv_map(cfg, one, x.device)[: cfg.n_heads])
    k, v = cache
    out, k, v = flash_decode_local(
        q, k, v, k_new, v_new, pos, 0, k.shape[2], kmap=kmap,
        scale=1.0 / math.sqrt(hd))
    out = _out(out, p["wo"][: cfg.n_heads])[:, None, :]
    if "bo" in p:
        out = out + p["bo"]
    return out, (k, v)


# ------------------------------------------------------------------ MLA
def _mla_q(p, x, cfg: ModelConfig, positions):
    """Latent-projected queries -> (q_nope, q_rope), (B,S,Hp,.)."""
    cq = _rms(x @ p["wq_a"], p["q_norm"])
    q = _proj(cq, p["wq_b"])
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = q[..., cfg.qk_nope_dim:]
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta,
                           upcast(q).dtype)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_kv_latent(p, x, cfg: ModelConfig, positions):
    """Compressed kv: (c_kv (B,S,kvr) normed, k_rope (B,S,rope) roped)."""
    kv_a = x @ p["wkv_a"]
    c_kv = _rms(kv_a[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., cfg.kv_lora_rank:]
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta,
                           upcast(x).dtype)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    return c_kv, k_rope


def apply_mla(p, x, cfg: ModelConfig, rt: RunSpec, *, positions):
    """MLA full-sequence attention.  Cache = packed latent
    (B, 1, S, kvr+rope) -- head-free, which is the whole point of MLA."""
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(p, x, cfg, positions)

    kv = _proj(c_kv, p["wkv_b"])
    k_nope = kv[..., :nope]
    v = kv[..., nope:]
    hp = q_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_rope.shape[:2], hp, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # pad v's head dim to match q/k attention output path
    vpad = torch.nn.functional.pad(v, (0, k.shape[-1] - vd))
    out = chunked_attention(q, k, vpad, causal=True, chunk=rt.attn_chunk,
                            scale=1.0 / math.sqrt(nope + cfg.qk_rope_dim))
    out = _out(out[..., :vd], p["wo"])
    cache = torch.cat([c_kv, k_rope], dim=-1)[:, None]    # (B,1,S,.)
    return out, cache


def _mla_flash_local(q, ck, new_ck, pos, shard_idx, s_loc, *,
                     axis: str | None = None, kvr: int, scale: float):
    """Absorbed-MLA decode body. q (B,H,kvr+rope); ck (B,1,S_loc,kvr+rope),
    updated in place; new_ck (B,1,kvr+rope)."""
    if axis is not None:
        raise NotImplementedError(_NO_MESH)
    pos = int(pos)
    _write_slot(ck, new_ck, pos, s_loc, shard_idx)
    sc = torch.einsum("bhe,bse->bhs", upcast(q) * scale,
                      upcast(ck[:, 0]))
    spos = shard_idx * s_loc + torch.arange(s_loc, device=q.device)
    sc = torch.where(spos[None, None, :] <= pos, sc, NEG_INF)
    m = torch.amax(sc, dim=-1)
    pexp = torch.exp(sc - m[..., None])
    l = torch.sum(pexp, dim=-1)
    o = torch.einsum("bhs,bsr->bhr", pexp, upcast(ck[:, 0, :, :kvr]))
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, ck


def mla_decode(p, x, cache, pos, cfg: ModelConfig, rt: RunSpec, *,
               mesh=None, seq_axis: str = "model"):
    """One-token absorbed-MLA decode over the latent cache (in place)."""
    if mesh is not None and seq_axis is not None:
        raise NotImplementedError(_NO_MESH)
    nope, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    h = cfg.n_heads
    posv = torch.full((x.shape[0], 1), int(pos), device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, posv)
    q_nope, q_rope = q_nope[:, 0, :h], q_rope[:, 0, :h]      # (B,H,.)
    c_new, kr_new = _mla_kv_latent(p, x, cfg, posv)
    new_ck = torch.cat([c_new[:, 0], kr_new[:, 0]], dim=-1)[:, None]

    # absorb W_UK:  q_lat[b,h,r] = sum_n q_nope[b,h,n] * wkv_b[r,h,n]
    w_uk = p["wkv_b"][..., :nope][:, :h]                     # (kvr,H,nope)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
    q = torch.cat([q_lat, q_rope], dim=-1)                   # (B,H,kvr+rope)
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    out, ck = _mla_flash_local(q, cache, new_ck, pos, 0, cache.shape[2],
                               kvr=kvr, scale=scale)

    # absorb W_UV: out[b,h,e] = sum_r out_lat[b,h,r] * wkv_b[r,h,nope+e]
    w_uv = p["wkv_b"][..., nope:][:, :h]                     # (kvr,H,vd)
    o = torch.einsum("bhr,rhe->bhe", out, w_uv)
    o = _out(o, p["wo"][:h])[:, None]
    return o, ck
