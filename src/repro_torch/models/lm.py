"""Full model assembly for the attention families, and its serving path.

Public surface (dispatches on cfg.family):

  param_defs(cfg, rt)                   -> ParamDef tree
  forward(params, batch, cfg, rt)       -> logits (train-style full seq)
  loss_fn(params, batch, cfg, rt)       -> scalar CE
  prefill(params, batch, cfg, rt, s_max)-> (logits_last, caches)
  decode_step(params, tok, caches, pos, cfg, rt) -> (logits, caches)
  cache_specs(cfg, rt, batch, s_max)    -> (meta-tensor tree, axes tree)
  LanguageModel(cfg, rt)                -> an nn.Module over the same tree
  stack_input(params, batch, cfg, rt)   -> (stack input, encoder output)
  head(params, x, cfg)                  -> logits of the stack's output

Batch dict keys per family (tensors, or numpy arrays moved to the
parameters' device):
  dense:  tokens (B,S), labels (B,S), mask (B,S)
  vlm:    + patches (B,n_img,frontend_dim); tokens are the text part
  audio:  frames (B,T,frontend_dim), tokens/labels/mask for the decoder

Logits are ``cfg.padded_vocab`` wide; the padding columns hold -1e30.
The families ``moe``, ``ssm`` and ``hybrid`` (models/moe.py,
models/mamba2.py, the zamba2 shared block) are not ported yet and raise
NotImplementedError naming ROADMAP A9b.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, RunSpec
from . import blocks, module
from .layers import (apply_embed, apply_lm_head, apply_norm, embed_defs,
                     gelu, lm_head_defs, norm_defs, upcast)
from .module import ParamDef, tree_map

FAMILIES = ("dense", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"({blocks.NEXT_SLICE}: models/moe.py, models/mamba2.py and "
            f"the hybrid stack); the port serves {', '.join(FAMILIES)}")


# =====================================================================
# param defs
# =====================================================================
def param_defs(cfg: ModelConfig, rt: RunSpec) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    defs: dict = {"embed": embed_defs(cfg.padded_vocab, d),
                  "final_norm": norm_defs(d)}
    if not cfg.tie_embeddings:
        defs["head"] = lm_head_defs(cfg.padded_vocab, d)
    if cfg.family in ("dense", "vlm"):
        defs["blocks"] = blocks.stack_defs(cfg, rt, cfg.n_layers)
    else:  # audio
        defs["frontend"] = {"w": ParamDef((cfg.frontend_dim, d),
                                          (None, None)),
                            "norm": norm_defs(d)}
        defs["encoder"] = blocks.stack_defs(_enc_cfg(cfg), rt,
                                            cfg.enc_layers)
        defs["enc_norm"] = norm_defs(d)
        defs["blocks"] = blocks.stack_defs(cfg, rt, cfg.n_layers, cross=True)
    if cfg.family == "vlm":
        defs["projector"] = {
            "norm": norm_defs(cfg.frontend_dim),
            "w1": ParamDef((cfg.frontend_dim, d), (None, "model")),
            "w2": ParamDef((d, d), ("model", None)),
        }
    return defs


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, family="dense")


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
        x = _input(batch, "frames", params) @ params["frontend"]["w"]
        return apply_norm(params["frontend"]["norm"], x, cfg.norm)
    tokens = _input(batch, "tokens", params)
    table = params["embed"]["table"]
    if rt.embed_via_matmul:
        onehot = F.one_hot(tokens.long(), cfg.padded_vocab).to(table.dtype)
        x = torch.einsum("bsv,vd->bsd", onehot, table) * cfg.scale_emb
    else:
        x = apply_embed(params["embed"], tokens) * cfg.scale_emb
    if cfg.family == "vlm":
        pj = params["projector"]
        v = apply_norm(pj["norm"], _input(batch, "patches", params),
                       "layernorm")
        v = gelu(v @ pj["w1"]) @ pj["w2"]
        x = torch.cat([v.to(x.dtype), x], dim=1)
    return x


def head(params, x, cfg: ModelConfig):
    """Final norm and (tied) LM head: (..., d) -> (..., padded_vocab)."""
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
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
    ``head`` it drives the stack one layer at a time."""
    _check_family(cfg)
    if cfg.family == "audio":
        enc = _encode(params, batch, cfg, rt)
        return (apply_embed(params["embed"], _input(batch, "tokens", params)),
                enc)
    return _embed_in(params, batch, cfg, rt), None


def forward(params, batch, cfg: ModelConfig, rt: RunSpec) -> torch.Tensor:
    x, enc = stack_input(params, batch, cfg, rt)
    x, _ = blocks.apply_stack(params["blocks"], x, cfg, rt,
                              positions=_positions(x.shape[1], x),
                              causal=True, enc_out=enc)
    if cfg.family == "vlm":
        x = x[:, cfg.n_frontend_tokens:]      # logits for text positions
    return head(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, rt: RunSpec) -> torch.Tensor:
    """Masked mean cross-entropy of the next-token labels."""
    logits = forward(params, batch, cfg, rt)
    labels = _input(batch, "labels", params).long()
    logits = upcast(logits)                 # the CE math in >= f32
    mask = _input(batch, "mask", params).to(logits.dtype)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (torch.sum((lse - picked) * mask)
            / torch.clamp(torch.sum(mask), min=1.0))


# =====================================================================
# serving: prefill + single-token decode
# =====================================================================
def _pad_cache_seq(cache, s_max: int):
    """Pad every cache leaf's sequence axis (-2) up to s_max."""
    return tree_map(lambda c: F.pad(c, (0, 0, 0, s_max - c.shape[-2])),
                    cache)


def prefill(params, batch, cfg: ModelConfig, rt: RunSpec, s_max: int):
    """Process the prompt, return (last-position logits, caches @ s_max).

    Caches carry a leading layer axis: dense/vlm (k, v) each
    (L, B, KV, s_max, hd), MLA one (L, B, 1, s_max, kvr+rope) latent,
    audio ((k, v), (k_x, v_x)) with the cross caches at the encoder
    length."""
    x, enc = stack_input(params, batch, cfg, rt)
    x, caches = blocks.apply_stack(params["blocks"], x, cfg, rt,
                                   positions=_positions(x.shape[1], x),
                                   causal=True, enc_out=enc,
                                   collect_cache=True)
    if enc is None:
        caches = _pad_cache_seq(caches, s_max)
    else:                                   # (self, cross)
        caches = (_pad_cache_seq(caches[0], s_max), caches[1])
    return head(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, tokens, caches, pos, cfg: ModelConfig,
                rt: RunSpec, mesh=None, seq_axis: str = "model"):
    """One token for every sequence in the batch.

    tokens (B,1) int; pos int (current write position).  The caches are
    written in place at slot ``pos`` and returned.  Returns (logits
    (B, padded_vocab), caches)."""
    _check_family(cfg)
    x = apply_embed(params["embed"],
                    torch.as_tensor(tokens, device=_device(params))
                    ) * cfg.scale_emb
    x, caches = blocks.apply_stack_decode(params["blocks"], x, caches, pos,
                                          cfg, rt, mesh=mesh,
                                          seq_axis=seq_axis)
    return head(params, x, cfg)[:, 0], caches


def cache_specs(cfg: ModelConfig, rt: RunSpec, batch: int, s_max: int,
                dtype=torch.bfloat16, enc_len: int | None = None):
    """(tree of ``meta`` tensors, tree of partition axes) for the decode
    caches, without allocating them.  The port serves on one device, so
    every axis is None (the reference's ``mesh=`` layouts are ROADMAP
    A9b)."""
    _check_family(cfg)
    l = cfg.n_layers
    spec = (None,) * 5

    def meta(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.mla:
        return (meta(l, batch, 1, s_max, cfg.kv_lora_rank + cfg.qk_rope_dim),
                spec)
    k = meta(l, batch, cfg.n_kv_heads, s_max, cfg.hd)
    if cfg.family == "audio":
        kx = meta(l, batch, cfg.n_kv_heads, enc_len or s_max, cfg.hd)
        return ((k, k), (kx, kx)), ((spec, spec), (spec, spec))
    return (k, k), (spec, spec)


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
    def decode_step(self, tokens, caches, pos):
        return decode_step(self.tree(), tokens, caches, pos, self.cfg,
                           self.rt)
