#!/usr/bin/env python
"""The readings behind tests/torch_lm_cases.py's parity bounds.

For each arch at its reduced config and each attention branch
(one-shot: 2 x 16 tokens, attn_chunk 64; scanned: 2100 tokens,
attn_chunk 512, 1050 tokens over 2100 frames for the audio backbone;
the SSM arch, which has no attention, one-shot only),
on the test's own weights and inputs, prints one JSON line with the
worst relative error over forward, prefill, decode and every cache leaf
of:

  ref32_vs_ref64    the reference's float32 against its float64
  port64_vs_ref64   the port's float64 against the reference's float64
  port32_vs_ref32   the port's float32 against the reference's float32
  port32_vs_port64  the port's float32 against its float64

The scanned branch's float32 reference runs op by op, as in the tests.
JAX on the CPU; about 8 minutes.

Usage: PYTHONPATH=src python scripts/lm_parity_readings.py
       [one-shot|scanned] [arch ...]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import torch_lm_cases as T  # noqa: E402


def worst(a, b, v):
    errs = [T.rel_err(a[i], b[i], v) for i in (0, 1, 3)]
    for i in (2, 4):
        errs += [T.rel_err(x, y) for x, y in zip(a[i], b[i])]
    return max(errs)


def main(argv):
    branches = [argv[0]] if argv else list(T.BRANCHES)
    for branch in branches:
        archs = argv[1:] or (T.ATTN_ARCHS if branch == "scanned"
                             else T.ARCHS)
        for arch in archs:
            case = T.Case(arch, branch)
            arrays, params = case.reference_weights()
            r32 = case.run_ref(arrays, eager=branch == "scanned")
            r64 = case.run_ref(arrays, f64=True)
            p32 = case.run_port(params)
            p64 = case.run_port(params, f64=True)
            v = case.cfg.vocab
            print(json.dumps({
                "arch": arch, "branch": branch,
                "ref32_vs_ref64": worst(r32, r64, v),
                "port64_vs_ref64": worst(p64, r64, v),
                "port32_vs_ref32": worst(p32, r32, v),
                "port32_vs_port64": worst(p32, p64, v)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
