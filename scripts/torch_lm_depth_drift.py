#!/usr/bin/env python3
"""How far decode drifts from forward with depth, at published width.

For a config cut to 1, 2, 4, 8 and its full number of layers (seeded
weights, the same at every depth), it runs ``lm.prefill`` over a prompt
and one ``lm.decode_step``, and ``lm.forward`` over the prompt and that
token, in float32 and in float64, and prints max |decode - forward| /
max |forward| over the logical vocabulary.  The two are the same math,
so the gap is rounding, amplified layer by layer; at the reference's
init (fan-in along the head axis, sharply peaked attention) it grows
by orders of magnitude per few layers.

    python3 scripts/torch_lm_depth_drift.py [--arch qwen1.5-0.5b]
        [--device cuda] [--batch 2] [--prompt 128]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def drift(cfg, dtype, device, batch, prompt):
    import numpy as np
    import torch

    from repro_torch.configs.base import RunSpec
    from repro_torch.models import lm, module

    rt = RunSpec()
    params = module.init(lm.param_defs(cfg, rt), device=device, generator=1)
    params = module.tree_map(lambda t: t.to(dtype), params)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (batch, prompt + 1))
    data = {"tokens": toks}
    if cfg.family == "audio":
        data["frames"] = rng.standard_normal(
            (batch, 2 * prompt, cfg.frontend_dim))
        data["frames"] = torch.as_tensor(data["frames"], dtype=dtype)
    with torch.no_grad():
        full = lm.forward(params, data, cfg, rt)[:, -1, : cfg.vocab]
        _, caches = lm.prefill(params, dict(data, tokens=toks[:, :-1]), cfg,
                               rt, prompt + 1)
        dec, _ = lm.decode_step(params, toks[:, -1:], caches, prompt, cfg,
                                rt)
    dec = dec[:, : cfg.vocab]
    return float((dec - full).abs().max() / full.abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=128)
    a = ap.parse_args()

    import torch

    import repro_torch.configs as configs

    torch.backends.cuda.matmul.allow_tf32 = False
    if a.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    base = configs.get(a.arch)
    for depth in sorted({1, 2, 4, 8, base.n_layers}):
        cfg = dataclasses.replace(base, n_layers=depth,
                                  enc_layers=min(depth, base.enc_layers))
        row = {"arch": a.arch, "layers": depth,
               "enc_layers": cfg.enc_layers, "device": a.device}
        for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
            row[f"decode_vs_forward_rel_{name}"] = drift(
                cfg, dt, a.device, a.batch, a.prompt)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
