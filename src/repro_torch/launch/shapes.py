"""Assigned input shapes x runtime policy per architecture.

Four shapes per the assignment (LM transformer shapes are
seq_len x global_batch):

  train_4k     seq=4,096   batch=256  -> traces train_step
  prefill_32k  seq=32,768  batch=32   -> traces prefill (serve)
  decode_32k   seq=32,768  batch=128  -> traces decode_step (1 new token
                                         against a seq_len KV cache)
  long_500k    seq=524,288 batch=1    -> decode_step; ONLY for
                                         sub-quadratic families (ssm,
                                         hybrid) -- skipped with a note
                                         for full-attention archs

Enc-dec policy (seamless): shapes give the ENCODER length; the decoder
runs seq/4 for train/prefill and one token at decode.
VLM policy (internvl2): shapes give the total backbone sequence; 256 of
those positions are image tokens from the ViT stub.

The counterpart of the reference's ``launch/shapes.py``.  An abstract
batch is a tree of ``meta`` tensors beside a tree of partition-axis
tuples, each equal to ``tuple()`` of the reference's ``PartitionSpec``
(as ``models.lm.cache_specs`` returns them).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.models import lm
from . import mesh as meshlib


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# gradient-accumulation factor for train_4k, sized so remat'd activations
# fit a 16 GB v5e alongside params + ZeRO-1 state (napkin math in DESIGN.md)
MICROBATCHES = {
    "minicpm3-4b": 8, "internlm2-20b": 16, "starcoder2-7b": 8,
    "qwen1.5-0.5b": 1, "arctic-480b": 16, "qwen3-moe-30b-a3b": 4,
    "internvl2-1b": 1, "zamba2-1.2b": 4, "mamba2-2.7b": 8,
    "seamless-m4t-large-v2": 2,
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def runspec_for(cfg: ModelConfig, shape: ShapeSpec, mesh) -> RunSpec:
    tp = mesh.shape["model"] if mesh is not None else 1
    dp = meshlib.data_size(mesh) if mesh is not None else 1
    mb = MICROBATCHES.get(cfg.name, 1) if shape.kind == "train" else 1
    return RunSpec(tp=tp, dp=dp,
                   remat="block" if shape.kind == "train" else "none",
                   microbatches=mb, attn_chunk=1024)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                dtype=torch.bfloat16):
    """(tree of ``meta`` tensors, tree of partition-axis tuples) of a
    cell's abstract inputs: train/prefill -> the batch dict; decode ->
    ``{"tokens", "caches", "pos"}``."""
    b, s = shape.batch, shape.seq
    dp = lm._axes(meshlib.data_axes(mesh)) if mesh is not None else None

    def toks(bb, ss):
        return _meta((bb, ss), torch.int32), (dp, None)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            s_text = s - cfg.n_frontend_tokens
            batch = {"tokens": toks(b, s_text),
                     "patches": (_meta((b, cfg.n_frontend_tokens,
                                        cfg.frontend_dim), dtype),
                                 (dp, None, None)),
                     "labels": toks(b, s_text),
                     "mask": (_meta((b, s_text), torch.float32), (dp, None))}
        elif cfg.family == "audio":
            s_dec = max(s // 4, 8)
            batch = {"frames": (_meta((b, s, cfg.frontend_dim), dtype),
                                (dp, None, None)),
                     "tokens": toks(b, s_dec),
                     "labels": toks(b, s_dec),
                     "mask": (_meta((b, s_dec), torch.float32), (dp, None))}
        else:
            batch = {"tokens": toks(b, s), "labels": toks(b, s),
                     "mask": (_meta((b, s), torch.float32), (dp, None))}
        if shape.kind == "prefill":
            batch = {k: v for k, v in batch.items()
                     if k not in ("labels", "mask")}
        return ({k: t for k, (t, _) in batch.items()},
                {k: a for k, (_, a) in batch.items()})

    # decode: (tokens, caches, pos)
    rt = runspec_for(cfg, shape, mesh)
    caches, cache_axes = lm.cache_specs(cfg, rt, b, s, dtype, mesh,
                                        enc_len=s)
    if mesh is None:
        tok_axes = (None, None)
    else:   # the reference's P(dp) over (b, 1), or P(None)
        tok_axes = ((dp,) if b % max(meshlib.data_size(mesh), 1) == 0
                    else (None,))
    return ({"tokens": _meta((b, 1), torch.int32), "caches": caches,
             "pos": _meta((), torch.int32)},
            {"tokens": tok_axes, "caches": cache_axes, "pos": ()})


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, key=0,
                   dtype=torch.float32):
    """Small REAL batch with the same structure (for smoke runs), on the
    CPU.  It draws from a CPU ``torch.Generator`` seeded by ``key``, not
    from the reference's ``jax.random`` stream (ROADMAP C11)."""
    g = torch.Generator().manual_seed(int(key))
    b, s = shape.batch, shape.seq

    def randint(*size):
        return torch.randint(0, cfg.vocab, size, generator=g,
                             dtype=torch.int32)

    def normal(*size):
        return torch.randn(size, generator=g, dtype=dtype)

    if cfg.family == "vlm":
        s_text = s - cfg.n_frontend_tokens
        return {"tokens": randint(b, s_text),
                "patches": normal(b, cfg.n_frontend_tokens,
                                  cfg.frontend_dim),
                "labels": randint(b, s_text),
                "mask": torch.ones((b, s_text), dtype=torch.float32)}
    if cfg.family == "audio":
        s_dec = max(s // 4, 8)
        return {"frames": normal(b, s, cfg.frontend_dim),
                "tokens": randint(b, s_dec),
                "labels": randint(b, s_dec),
                "mask": torch.ones((b, s_dec), dtype=torch.float32)}
    toks = randint(b, s)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1),
            "mask": torch.ones((b, s), dtype=torch.float32)}
