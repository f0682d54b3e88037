#!/usr/bin/env python
"""How much precision the reference's compiled layer scan loses.

``repro.models.blocks.apply_stack`` runs its layers under
``jax.lax.scan``, whose body XLA compiles as one computation; the same
code under ``jax.disable_jit()`` runs op by op.  This prints, for the
reference alone (JAX on the CPU):

  * the RoPE cos table ``layers.rope_angles`` gives, jitted and op by
    op, against float64 cos of the same float32 angles;
  * for each attention arch at its reduced config, max |compiled -
    op by op| / max |op by op| of ``lm.forward``'s logits, at 16 tokens
    (one-shot attention) and at 2100 tokens (the scanned branch,
    attn_chunk 512; the audio backbone's encoder sees 2100 frames under
    1050 tokens).

Weights are the reference's ``module.init(PRNGKey(0))`` with a crc32
``hash`` in place of Python's per-process one, so runs agree.

Usage: PYTHONPATH=src python scripts/reference_scan_precision.py
"""
from __future__ import annotations

import json
import zlib

import numpy as np

import jax
import jax.numpy as jnp

import repro.configs as configs
import repro.models.module as module
from repro.configs.base import RunSpec
from repro.models import layers, lm

ARCHS = ["minicpm3-4b", "internlm2-20b", "starcoder2-7b", "qwen1.5-0.5b",
         "internvl2-1b", "seamless-m4t-large-v2"]


def rope_error(theta=1e6, dim=16, n=2100):
    pos = jnp.arange(n)[None]
    eager, _ = layers.rope_angles(pos, dim, theta)
    jitted, _ = jax.jit(lambda p: layers.rope_angles(p, dim, theta))(pos)
    inv = 1.0 / (np.float32(theta) ** (np.arange(0, dim, 2, dtype=np.float32)
                                        / dim))
    ang = (np.arange(n, dtype=np.float32)[:, None]
           * inv.astype(np.float32)).astype(np.float64)
    exact = np.cos(ang)
    return (float(np.abs(np.asarray(jitted)[0] - exact).max()),
            float(np.abs(np.asarray(eager)[0] - exact).max()))


def batch(cfg, b, s):
    rng = np.random.default_rng(0)
    out = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "vlm":
        out["patches"] = jnp.asarray(rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)), jnp.float32)
    if cfg.family == "audio":
        out["frames"] = jnp.asarray(rng.standard_normal(
            (b, 2 * s, cfg.frontend_dim)), jnp.float32)
    return out


def compiled_vs_op_by_op(arch, b, s, chunk):
    cfg = configs.get(arch, reduced=True)
    rt = RunSpec(tp=1, remat="none", attn_chunk=chunk)
    module.hash = lambda name: zlib.crc32(name.encode())
    try:
        params = module.init(jax.random.PRNGKey(0), lm.param_defs(cfg, rt))
    finally:
        del module.hash
    data = batch(cfg, b, s)
    compiled = np.asarray(lm.forward(params, data, cfg, rt), np.float64)
    with jax.disable_jit():
        eager = np.asarray(lm.forward(params, data, cfg, rt), np.float64)
    return float(np.abs(compiled - eager).max() / np.abs(eager).max())


def main():
    jit_err, eager_err = rope_error()
    print(json.dumps({"rope_cos_max_abs_err": {"jit": jit_err,
                                               "op_by_op": eager_err}}))
    for arch in ARCHS:
        long = 1050 if arch == "seamless-m4t-large-v2" else 2100
        print(json.dumps({
            "arch": arch,
            "one_shot_16": compiled_vs_op_by_op(arch, 2, 16, 64),
            f"scanned_{long}": compiled_vs_op_by_op(arch, 1, long, 512)}),
            flush=True)


if __name__ == "__main__":
    main()
