#!/usr/bin/env python3
"""Does a record's result depend on how many records one call sees?

Runs the step's per-record operations of the paper's set-1 paths on the
card twice over the same 8 records: once as one call over all 8, once
as 4 calls over 2 records each (what one executor of 4 would see if the
step ran once per executor), and prints, per operation, whether the two
agree bit for bit and their largest relative difference.  The sharded
engine runs the step once per logical shard, so it does not depend on
the answer; this script records why.

Usage (from the root of a checkout; ``--device cpu`` asks the same of
the kernels' plain versions):
    python3 scripts/torch_batch_bits.py [--records 8] [--split 4]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np      # noqa: E402
import torch            # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=8)
    ap.add_argument("--split", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the kernels' plain versions")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU (or --device cpu)")
    from repro_torch.api.features import FeatureContext, get_feature
    from repro_torch.core import spectra
    from repro_torch.core.params import PARAM_SET_1
    from repro_torch.core.tol import band_matrix
    from repro_torch.kernels import ops

    p = PARAM_SET_1
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(a.device)
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.standard_normal(
        (a.records, p.record_size)).astype(np.float32) * 0.1, device=dev)
    # a loud burst per record, so that events (and impulsive rows) exist
    for i in range(a.records):
        s0 = (i + 1) * p.record_size // (a.records + 2)
        x[i, s0:s0 + 4096] += 3.0
    bm = torch.as_tensor(band_matrix(p), device=dev)
    imp = get_feature("impulsive")
    pe = dataclasses.replace(p, event_threshold_db=-5.0)

    ops_ = {
        "K1 welch_psd": lambda r: ops.welch_psd(r, p),
        "spl = sum(welch) over bins": lambda r: spectra.spl_wideband(
            ops.welch_psd(r, p), p),
        "K4 tol_levels": lambda r: ops.tol_levels(ops.welch_psd(r, p), bm,
                                                  p),
        "K5 frame_psd": lambda r: ops.frame_psd(r, p),
        "frame_spl = sum(frame_psd) over bins": lambda r: spectra.db(
            torch.sum(ops.frame_psd(r, p), dim=-1) * p.df, p),
        "K7 impulsive_metrics": lambda r: imp.compute(
            FeatureContext(r, pe, True, {}))[1],
    }
    per = a.records // a.split
    out = {}
    for name, fn in ops_.items():
        whole = fn(x)
        parts = torch.cat([fn(x[i * per:(i + 1) * per])
                           for i in range(a.split)])
        same = bool(torch.equal(whole, parts))
        w, q = whole.double(), parts.double()
        fin = torch.isfinite(w) & torch.isfinite(q)
        rel = float(((w - q).abs() / w.abs().clamp_min(1e-30))[fin].max()) \
            if fin.any() else 0.0
        out[name] = {"bitwise": same, "max_rel": rel}
        print(f"{name}: {a.records} records in one call vs {a.split} "
              f"calls of {per}: {'same bits' if same else 'DIFFERENT'}"
              f" (max rel {rel:.3e})")
    n_ev = int(ops.detect_events(
        spectra.db(torch.sum(ops.frame_psd(x, pe), dim=-1) * pe.df, pe),
        torch.argmax(ops.frame_psd(x, pe), dim=-1).to(torch.int32), pe,
        kernel=True)[0].sum())
    print(f"{n_ev} events over the {a.records} records")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
