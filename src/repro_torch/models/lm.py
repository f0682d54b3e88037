"""Full model assembly for all architecture families, and its serving
path.

Public surface (dispatches on cfg.family):

  param_defs(cfg, rt)                   -> ParamDef tree
  forward(params, batch, cfg, rt)       -> logits (train-style full seq)
  loss_fn(params, batch, cfg, rt)       -> scalar CE (+ MoE aux)
  prefill(params, batch, cfg, rt, s_max)-> (logits_last, caches)
  decode_step(params, tok, caches, pos, cfg, rt, mesh) -> (logits, caches)
  cache_specs(cfg, rt, batch, s_max, mesh=) -> (meta-tensor tree, axes tree)
  shard_caches / gather_caches          -> prefill's caches over a mesh, back
  LanguageModel(cfg, rt)                -> an nn.Module over the same tree
  stack_input(params, batch, cfg, rt)   -> (stack input, encoder output)
  head(params, x, cfg)                  -> logits of the stack's output

Batch dict keys per family (tensors, or numpy arrays moved to the
parameters' device):
  dense/moe:  tokens (B,S), labels (B,S), mask (B,S)
  vlm:        + patches (B,n_img,frontend_dim); tokens are the text part
  audio:      frames (B,T,frontend_dim), tokens/labels/mask for the decoder
  ssm/hybrid: as dense

Logits are ``cfg.padded_vocab`` wide; the padding columns hold -1e30.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, RunSpec
from . import attention, blocks, module, moe
from .layers import (apply_embed, apply_lm_head, apply_mlp, apply_norm,
                     einsum, embed_defs, gelu, lm_head_defs, mlp_defs, mm,
                     norm_defs, upcast)
from .module import ParamDef, stack, tree_map

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
_BLOCK_FAMILIES = ("dense", "moe", "vlm", "audio")   # attention blocks


# =====================================================================
# param defs
# =====================================================================
def _zamba_shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The zamba2 shared block runs at width 2*d (concat [h, x_emb])."""
    return dataclasses.replace(
        cfg, d_model=2 * cfg.d_model, head_dim=2 * cfg.d_model // cfg.n_heads,
        n_experts=0, family="dense")


def n_attn_sites(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.attn_every)


def param_defs(cfg: ModelConfig, rt: RunSpec) -> dict:
    d = cfg.d_model
    defs: dict = {"embed": embed_defs(cfg.padded_vocab, d),
                  "final_norm": norm_defs(d)}
    if not cfg.tie_embeddings:
        defs["head"] = lm_head_defs(cfg.padded_vocab, d)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        defs["blocks"] = blocks.stack_defs(cfg, rt, cfg.n_layers)
    elif fam in ("ssm", "hybrid"):
        defs["blocks"] = stack(blocks.mamba_block_defs(cfg, rt),
                               cfg.n_layers)
    elif fam == "audio":
        defs["frontend"] = {"w": ParamDef((cfg.frontend_dim, d),
                                          (None, None)),
                            "norm": norm_defs(d)}
        defs["encoder"] = blocks.stack_defs(_enc_cfg(cfg), rt,
                                            cfg.enc_layers)
        defs["enc_norm"] = norm_defs(d)
        defs["blocks"] = blocks.stack_defs(cfg, rt, cfg.n_layers, cross=True)
    else:
        raise ValueError(f"{cfg.name}: unknown family {fam!r}")
    if fam == "hybrid":
        scfg = _zamba_shared_cfg(cfg)
        defs["shared"] = {
            "norm": norm_defs(scfg.d_model),
            "attn": attention.attn_defs(scfg, rt),
            "norm2": norm_defs(scfg.d_model),
            "mlp": mlp_defs(scfg.d_model, cfg.d_ff, cfg.mlp),
            "proj": ParamDef((scfg.d_model, d), (None, None)),
        }
        if cfg.shared_lora_rank:
            ns, r = n_attn_sites(cfg), cfg.shared_lora_rank
            defs["lora_a"] = ParamDef((ns, scfg.d_model, r),
                                      (None, None, None), scale=0.01)
            defs["lora_b"] = ParamDef((ns, r, scfg.d_model),
                                      (None, None, None), init="zeros")
    if fam == "vlm":
        defs["projector"] = {
            "norm": norm_defs(cfg.frontend_dim),
            "w1": ParamDef((cfg.frontend_dim, d), (None, "model")),
            "w2": ParamDef((d, d), ("model", None)),
        }
    return defs


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense")


# =====================================================================
# shared-block helpers (zamba2)
# =====================================================================
def _apply_shared(shared, lora, x, x0, cfg: ModelConfig, rt: RunSpec, *,
                  positions, cache=None, pos=None, mesh=None,
                  seq_axis="model"):
    """Zamba2 shared attention block on concat([x, x0]); returns (dx,
    cache) -- with ``cache`` given, one decode step written into it."""
    scfg = _zamba_shared_cfg(cfg)
    h = torch.cat([x, x0], dim=-1)
    if lora is not None:
        la, lb = lora
        h = h + mm(mm(h, la), lb)
    h = apply_norm(shared["norm"], h, cfg.norm)
    if cache is None:
        a, cache = attention.apply_attn(shared["attn"], h, scfg, rt,
                                        positions=positions, causal=True)
    else:
        a, cache = attention.decode_attn(shared["attn"], h, cache, pos,
                                         scfg, rt, mesh=mesh,
                                         seq_axis=seq_axis)
    h = h + a
    m = apply_mlp(shared["mlp"], apply_norm(shared["norm2"], h, cfg.norm),
                  cfg.mlp)
    return mm(h + m, shared["proj"]), cache


def site_lora(params, site: int):
    """Site ``site``'s LoRA pair of the shared block, or None."""
    if "lora_a" not in params:
        return None
    return params["lora_a"][site], params["lora_b"][site]


def _hybrid_stack(params, x, cfg: ModelConfig, rt: RunSpec, *, positions,
                  mamba_caches=None, attn_caches=None, pos=None,
                  decode=False, mesh=None, seq_axis="model"):
    """Loop over the mamba blocks, the shared attention block before
    every cfg.attn_every-th, fed the stack's input ``x0`` beside the
    hidden state.

    Site KV caches are stacked (n_sites, ...): at prefill each site's
    cache is written (zero-padded to s_max) at its site index; at decode
    each site's slot is written in place.  The mamba caches, stacked
    over the layers, are written in place at decode and collected at
    prefill.  Returns (x, mamba caches, attention caches)."""
    x0 = x
    k_every = cfg.attn_every
    collected = []
    mamba_layers = None if decode else blocks.layers(params["blocks"])
    for i in range(cfg.n_layers):
        if i % k_every == 0:
            site = i // k_every
            lora = site_lora(params, site)
            if decode:
                dx, _ = _apply_shared(
                    params["shared"], lora, x, x0, cfg, rt,
                    positions=positions, cache=blocks.layer(attn_caches,
                                                            site),
                    pos=pos, mesh=mesh, seq_axis=seq_axis)
            else:
                dx, cache = _apply_shared(params["shared"], lora, x, x0,
                                          cfg, rt, positions=positions)
                if attn_caches is not None:
                    for full, c in zip(attn_caches, cache):
                        full[site, :, :, : c.shape[-2]] = c
            x = x + dx
        if decode:
            lp = blocks.layer(params["blocks"], i)
            x, new = blocks.apply_mamba_block_decode(
                lp, x, blocks.layer(mamba_caches, i), cfg, rt)
            _put(mamba_caches, i, new)
        else:
            x, new = blocks.apply_mamba_block(mamba_layers[i], x, cfg, rt)
            collected.append(new)
    if not decode:
        mamba_caches = tree_map(lambda *c: torch.stack(c), *collected)
    return x, mamba_caches, attn_caches


def _put(stacked, i: int, new) -> None:
    """Write one layer's new cache into slot ``i`` of a stacked cache."""
    tree_map(lambda full, c: full[i].copy_(c), stacked, new)


# =====================================================================
# forward / loss
# =====================================================================
def _device(params) -> torch.device:
    return params["embed"]["table"].device


def _input(batch, key, params):
    return torch.as_tensor(batch[key], device=_device(params))


def _embed_in(params, batch, cfg: ModelConfig, rt: RunSpec):
    """Token/patch/frame embedding -> x (B, S, d)."""
    if cfg.family == "audio":
        x = mm(_input(batch, "frames", params), params["frontend"]["w"])
        return apply_norm(params["frontend"]["norm"], x, cfg.norm)
    tokens = _input(batch, "tokens", params)
    table = params["embed"]["table"]
    if rt.embed_via_matmul:
        onehot = F.one_hot(tokens.long(), cfg.padded_vocab).to(table.dtype)
        x = einsum("bsv,vd->bsd", onehot, table) * cfg.scale_emb
    else:
        x = apply_embed(params["embed"], tokens) * cfg.scale_emb
    if cfg.family == "vlm":
        pj = params["projector"]
        v = apply_norm(pj["norm"], _input(batch, "patches", params),
                       "layernorm")
        v = mm(gelu(mm(v, pj["w1"])), pj["w2"])
        x = torch.cat([v.to(x.dtype), x], dim=1)
    return x


def head(params, x, cfg: ModelConfig):
    """Final norm and (tied) LM head: (..., d) -> (..., padded_vocab)."""
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = mm(x, params["embed"]["table"].T)
    else:
        logits = apply_lm_head(params["head"], x)
    if cfg.padded_vocab != cfg.vocab:
        # mask Megatron vocab-padding rows out of the distribution
        logits[..., cfg.vocab:] = -1e30
    return logits


def _positions(n: int, x):
    return torch.arange(n, device=x.device)[None, :]


def _encode(params, batch, cfg: ModelConfig, rt: RunSpec):
    enc = _embed_in(params, batch, cfg, rt)
    enc, _ = blocks.apply_stack(params["encoder"], enc, _enc_cfg(cfg), rt,
                                positions=_positions(enc.shape[1], enc),
                                causal=False)
    return apply_norm(params["enc_norm"], enc, cfg.norm)


def stack_input(params, batch, cfg: ModelConfig, rt: RunSpec):
    """(x, enc_out): what ``forward`` and ``prefill`` feed the decoder
    stack for ``batch`` -- the embedded tokens (behind the VLM prefix)
    and the audio encoder's output (None for the other families).  With
    ``blocks.layer``, ``apply_block``, ``apply_block_decode`` and
    ``head`` it drives an attention stack one layer at a time; with
    ``blocks.apply_mamba_block[_decode]`` (and ``_apply_shared``) an SSM
    or hybrid one."""
    if cfg.family == "audio":
        enc = _encode(params, batch, cfg, rt)
        return (apply_embed(params["embed"], _input(batch, "tokens", params)),
                enc)
    return _embed_in(params, batch, cfg, rt), None


def _ssm_stack(params, x, cfg: ModelConfig, rt: RunSpec):
    """The mamba layers in order; returns (x, caches stacked over the
    layers)."""
    caches = []
    for lp in blocks.layers(params["blocks"]):
        x, cache = blocks.apply_mamba_block(lp, x, cfg, rt)
        caches.append(cache)
    return x, tree_map(lambda *c: torch.stack(c), *caches)


def forward(params, batch, cfg: ModelConfig, rt: RunSpec) -> torch.Tensor:
    x, enc = stack_input(params, batch, cfg, rt)
    positions = _positions(x.shape[1], x)
    if cfg.family in _BLOCK_FAMILIES:
        x, _ = blocks.apply_stack(params["blocks"], x, cfg, rt,
                                  positions=positions, causal=True,
                                  enc_out=enc)
    elif cfg.family == "ssm":
        x, _ = _ssm_stack(params, x, cfg, rt)
    else:  # hybrid
        x, _, _ = _hybrid_stack(params, x, cfg, rt, positions=positions)
    if cfg.family == "vlm":
        x = x[:, cfg.n_frontend_tokens:]      # logits for text positions
    return head(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, rt: RunSpec) -> torch.Tensor:
    """Masked mean cross-entropy of the next-token labels (plus 0.01 x
    the router's load-balancing loss for an MoE)."""
    logits = forward(params, batch, cfg, rt)
    labels = _input(batch, "labels", params).long()
    logits = upcast(logits)                 # the CE math in >= f32
    mask = _input(batch, "mask", params).to(logits.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = (torch.sum((lse - picked) * mask)
          / torch.clamp(torch.sum(mask), min=1.0))
    if cfg.n_experts:
        ce = ce + 0.01 * _moe_aux(params, batch, cfg, rt)
    return ce


def _moe_aux(params, batch, cfg: ModelConfig, rt: RunSpec):
    """The router aux loss of the first layer on the embedded input (the
    reference's cheap proxy)."""
    x = _embed_in(params, batch, cfg, rt)
    first = blocks.layer(params["blocks"]["ffn"], 0)
    return moe.aux_load_loss(first, x, cfg)


# =====================================================================
# serving: prefill + single-token decode
# =====================================================================
def _pad_cache_seq(cache, s_max: int):
    """Pad every cache leaf's sequence axis (-2) up to s_max."""
    return tree_map(lambda c: F.pad(c, (0, 0, 0, s_max - c.shape[-2])),
                    cache)


def prefill(params, batch, cfg: ModelConfig, rt: RunSpec, s_max: int):
    """Process the prompt, return (last-position logits, caches @ s_max).

    Caches carry a leading layer axis: dense/moe/vlm (k, v) each
    (L, B, KV, s_max, hd), MLA one (L, B, 1, s_max, kvr+rope) latent,
    audio ((k, v), (k_x, v_x)) with the cross caches at the encoder
    length; ssm (state (L, B, nh, ds, hd), (conv_x, conv_B, conv_C)), the
    same whatever the prompt length; hybrid (those mamba caches, (k, v)
    each (n_sites, B, KV, s_max, hd))."""
    x, enc = stack_input(params, batch, cfg, rt)
    positions = _positions(x.shape[1], x)
    if cfg.family in _BLOCK_FAMILIES:
        x, caches = blocks.apply_stack(params["blocks"], x, cfg, rt,
                                       positions=positions, causal=True,
                                       enc_out=enc, collect_cache=True)
        if enc is None:
            caches = _pad_cache_seq(caches, s_max)
        else:                               # (self, cross)
            caches = (_pad_cache_seq(caches[0], s_max), caches[1])
    elif cfg.family == "ssm":
        x, caches = _ssm_stack(params, x, cfg, rt)
    else:  # hybrid
        acaches = init_hybrid_attn_cache(cfg, rt, x.shape[0], s_max,
                                         x.dtype, x.device)
        x, mcaches, acaches = _hybrid_stack(params, x, cfg, rt,
                                            positions=positions,
                                            attn_caches=acaches)
        caches = (mcaches, acaches)
    return head(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, tokens, caches, pos, cfg: ModelConfig,
                rt: RunSpec, mesh=None, seq_axis: str = "model"):
    """One token for every sequence in the batch.

    tokens (B,1) int; pos int (current write position).  The caches are
    written in place (the attention caches at slot ``pos``) and
    returned.  With ``mesh`` (a ``launch.mesh.HostMesh``) the attention
    caches are the sequence shards of ``shard_caches``.  Returns (logits
    (B, padded_vocab), caches)."""
    x = apply_embed(params["embed"],
                    torch.as_tensor(tokens, device=_device(params))
                    ) * cfg.scale_emb
    if cfg.family in _BLOCK_FAMILIES:
        x, caches = blocks.apply_stack_decode(params["blocks"], x, caches,
                                              pos, cfg, rt, mesh=mesh,
                                              seq_axis=seq_axis)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x, new = blocks.apply_mamba_block_decode(
                blocks.layer(params["blocks"], i), x,
                blocks.layer(caches, i), cfg, rt)
            _put(caches, i, new)
    else:  # hybrid
        mcaches, acaches = caches
        x, _, _ = _hybrid_stack(params, x, cfg, rt, positions=None,
                                mamba_caches=mcaches, attn_caches=acaches,
                                pos=pos, decode=True, mesh=mesh,
                                seq_axis=seq_axis)
    return head(params, x, cfg)[:, 0], caches


# =====================================================================
# caches: constructors, specs, mesh layout
# =====================================================================
def init_hybrid_attn_cache(cfg: ModelConfig, rt: RunSpec, batch: int,
                           s_max: int, dtype=torch.bfloat16, device="cpu"):
    scfg = _zamba_shared_cfg(cfg)
    shape = (n_attn_sites(cfg), batch, scfg.n_kv_heads, s_max, scfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def cache_specs(cfg: ModelConfig, rt: RunSpec, batch: int, s_max: int,
                dtype=torch.bfloat16, mesh=None, seq_axis: str = "model",
                enc_len: int | None = None):
    """(tree of ``meta`` tensors, tree of partition axes) for the decode
    caches, without allocating them.  The axes follow
    ``attention.decode_layout``: batch over the data axes when it
    divides, otherwise the sequence over every mesh axis; every axis is
    None without a mesh.  Each axes tuple equals ``tuple()`` of the
    reference's ``PartitionSpec``."""
    l = cfg.n_layers
    fam = cfg.family
    if mesh is not None:
        dp, seq = (_axes(a) for a in attention.decode_layout(mesh, batch,
                                                             seq_axis))
        tp = "model"
    else:
        dp, seq, tp = None, None, None
    kv_axes = (None, dp, None, seq, None)

    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    if fam in ("dense", "moe", "vlm"):
        if cfg.mla:
            return (meta(l, batch, 1, s_max,
                         cfg.kv_lora_rank + cfg.qk_rope_dim), kv_axes)
        k = meta(l, batch, cfg.n_kv_heads, s_max, cfg.hd)
        return (k, k), (kv_axes, kv_axes)
    if fam == "ssm":
        st = meta(l, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim,
                  dt=torch.promote_types(dtype, torch.float32))
        cx = meta(l, batch, cfg.ssm_conv - 1, cfg.ssm_heads,
                  cfg.ssm_headdim)
        cb = meta(l, batch, cfg.ssm_conv - 1, cfg.ssm_state)
        cb_s = (None, dp, None, None)
        return ((st, (cx, cb, cb)),
                ((None, dp, tp, None, None),
                 ((None, dp, None, tp, None), cb_s, cb_s)))
    if fam == "hybrid":
        mc, mc_s = cache_specs(dataclasses.replace(cfg, family="ssm"), rt,
                               batch, s_max, dtype, mesh, seq_axis)
        scfg = _zamba_shared_cfg(cfg)
        a = meta(n_attn_sites(cfg), batch, scfg.n_kv_heads, s_max, scfg.hd)
        return (mc, (a, a)), (mc_s, (kv_axes, kv_axes))
    if fam == "audio":
        k = meta(l, batch, cfg.n_kv_heads, s_max, cfg.hd)
        kx = meta(l, batch, cfg.n_kv_heads, enc_len or s_max, cfg.hd)
        return ((k, k), (kx, kx)), ((kv_axes, kv_axes), (kv_axes, kv_axes))
    raise ValueError(fam)


def _axes(names: tuple):
    """Mesh axes of one dimension as a ``PartitionSpec`` entry reads:
    None, one name, or a tuple of names."""
    if not names:
        return None
    return names[0] if len(names) == 1 else tuple(names)


def _map_attn(fn, caches, cfg: ModelConfig):
    """Apply ``fn`` to each sequence-sharded leaf (a cache tensor, or
    the list of its shards) of a decode cache tree: every attention
    self-cache; not the audio cross caches, nor the SSM state."""
    def each(t):
        return tuple(each(c) for c in t) if isinstance(t, tuple) else fn(t)

    if cfg.family == "ssm":
        return caches
    if cfg.family == "hybrid":
        return caches[0], each(caches[1])
    if cfg.family == "audio":
        return each(caches[0]), caches[1]
    return each(caches)


def shard_caches(caches, cfg: ModelConfig, mesh, batch: int,
                 seq_axis: str = "model"):
    """Prefill's caches laid out for ``decode_step(mesh=mesh)``: each
    attention cache becomes one tensor per sequence shard, on that
    shard's device (``attention.decode_shards``); the rest stay whole."""
    lay = attention.decode_shards(mesh, batch, seq_axis)
    return _map_attn(lay.split, caches, cfg)


def gather_caches(caches, cfg: ModelConfig, mesh, batch: int,
                  seq_axis: str = "model"):
    """The inverse of ``shard_caches``, on the mesh's first device."""
    lay = attention.decode_shards(mesh, batch, seq_axis)
    return _map_attn(lay.gather, caches, cfg)


# =====================================================================
# the nn.Module
# =====================================================================
class _Tree(nn.Module):
    """A nested dict of tensors registered as parameters and submodules,
    so that ``state_dict`` keys mirror the reference's tree paths
    (``blocks.attn.wq`` for ``blocks/attn/wq``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LanguageModel(nn.Module):
    """``forward``/``prefill``/``decode_step`` over one parameter tree.

    The tree is ``module.init(param_defs(cfg, rt), device=device,
    generator=generator)``, or ``params`` when given (for example
    ``module.from_numpy(param_defs(cfg, rt), arrays, device)`` of the
    reference's weights).  Its parameters do not require grad: this is
    the serving path.  numpy inputs are moved to the model's device.
    """

    def __init__(self, cfg: ModelConfig, rt: RunSpec | None = None, *,
                 device="cuda", generator=None, params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        self.rt = rt or RunSpec()
        if params is None:
            params = module.init(param_defs(cfg, self.rt), device=device,
                                 generator=generator)
        self.params = _Tree(params)

    def tree(self) -> dict:
        return self.params.tree()

    @torch.no_grad()
    def forward(self, batch) -> torch.Tensor:
        return forward(self.tree(), batch, self.cfg, self.rt)

    @torch.no_grad()
    def prefill(self, batch, s_max: int):
        return prefill(self.tree(), batch, self.cfg, self.rt, s_max)

    @torch.no_grad()
    def decode_step(self, tokens, caches, pos, mesh=None,
                    seq_axis: str = "model"):
        return decode_step(self.tree(), tokens, caches, pos, self.cfg,
                           self.rt, mesh=mesh, seq_axis=seq_axis)
