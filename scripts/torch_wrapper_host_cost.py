#!/usr/bin/env python3
"""Host cost of the six launch wrappers (K1-K6) of the PyTorch/CUDA
port.

Run on a machine with a CUDA GPU, from the root of a checkout:

    python3 scripts/torch_wrapper_host_cost.py [--src DIR] [--label NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that two trees can be compared in one
run.  For ``framepsd.welch_psd`` and ``framepsd.frame_psd`` at paper set
1 ((8, 1 966 080) f32), ``ct_rfft.ct_frame_psd`` at paper set 2 ((640,
4096) f32), ``welch.welch_mean`` at set 2 ((8, 80, 2049) f32),
``tol.tol_levels`` at set 2 ((8, 2049) x (2049, 33)) and
``events.detect_events`` at set 1 ((8, 15 359) f32 + int32) it times,
in host microseconds per call: the whole wrapper, the bare C entry point
with its arguments ready (K5's by the tree's own entry point: with a
launch plan, or the earlier one that takes its constants one by one),
and the pieces a wrapper may spend its time on (hashing
the parameters, an ``lru_cache`` lookup, entering and leaving
``torch.cuda.device``, the current stream, a ctypes pointer array,
``torch.empty``).
Each figure is the median over rounds of the wall time of many calls
with no synchronize, divided by their number; the card is held busy by
a spin first so that launches queue and never wait.  Prints the card's
name and power limit and one JSON line.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROUNDS, REPS = 7, 50


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("measures the wrappers on a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2
    from repro_torch.core.tol import band_matrix
    from repro_torch.kernels import (_build, ct_rfft, events, framepsd, tol,
                                     welch)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.library()
    rng = np.random.default_rng(1)
    p1, p2 = PARAM_SET_1, PARAM_SET_2
    x1 = torch.as_tensor(rng.standard_normal((8, p1.record_size)),
                         dtype=torch.float32, device=dev)
    x2 = torch.as_tensor(rng.standard_normal((640, p2.window_size)),
                         dtype=torch.float32, device=dev)
    psd4 = torch.as_tensor(rng.random((8, p2.n_bins)), dtype=torch.float32,
                           device=dev)
    bm4 = torch.as_tensor(band_matrix(p2), device=dev)
    x3 = torch.as_tensor(rng.random((8, p2.frames_per_record, p2.n_bins)),
                         dtype=torch.float32, device=dev)
    n = x1.shape[1]
    fpr1 = (n - p1.window_size) // p1.hop + 1
    spl6 = torch.as_tensor(rng.standard_normal((8, fpr1)) * 3.0 - 20.0,
                           dtype=torch.float32, device=dev)
    pb6 = torch.as_tensor(rng.integers(0, p1.n_bins, (8, fpr1)),
                          dtype=torch.int32, device=dev)
    ev6 = dict(threshold_db=-17.0, hysteresis_db=2.0, min_len=1,
               capacity=16)
    stream = torch.cuda.current_stream().cuda_stream
    out1 = torch.empty((8, p1.n_bins), device=dev)
    out2 = torch.empty((640, p2.n_bins), device=dev)
    out4 = torch.empty((8, bm4.shape[1]), device=dev)
    out5 = torch.empty((8, fpr1, p1.n_bins), device=dev)
    out3 = torch.empty((8, p2.n_bins), device=dev)
    counts6 = torch.empty((8,), dtype=torch.int32, device=dev)
    rows6 = torch.empty((8, 16, 4), device=dev)

    # The bare C calls, with their arguments ready.
    plan1 = framepsd._welch_plan(p1, n, dev)
    part1 = torch.empty((8, plan1.n_chunks, plan1.cols), device=dev)
    bare1 = functools.partial(
        plan1.f32, x1.data_ptr(), n, n, *plan1.mid, part1.data_ptr(),
        out1.data_ptr(), 8, *plan1.tail, stream)
    plan2 = ct_rfft._plan(p2, dev)
    bare2 = functools.partial(
        plan2.f32, x2.data_ptr(), p2.window_size, *plan2.mid,
        out2.data_ptr(), 640, *plan2.tail, stream)
    bare4 = functools.partial(
        _build.function("depam_tol_levels", _build.P, _build.P, _build.P,
                        _build.I, _build.I, _build.I, _build.F, _build.F,
                        _build.P),
        psd4.data_ptr(), bm4.data_ptr(), out4.data_ptr(), 8, p2.n_bins,
        bm4.shape[1], float(p2.df), float(p2.gain_db), stream)
    if hasattr(framepsd, "_frame_plan"):
        plan5 = framepsd._frame_plan(p1, dev)
        bare5 = functools.partial(
            plan5.f32, x1.data_ptr(), n, n, *plan5.mid, out5.data_ptr(), 8,
            fpr1, *plan5.tail, stream)
    else:
        c, s, sc = framepsd._device_constants(p1, 1, str(dev))
        fn5 = _build.function("depam_frame_psd_f32", _build.P, _build.L,
                              _build.L, *(_build.P,) * 4, *(_build.I,) * 5,
                              _build.P)
        bare5 = functools.partial(
            fn5, x1.data_ptr(), n, n, c.data_ptr(), s.data_ptr(),
            sc.data_ptr(), out5.data_ptr(), 8, fpr1, p1.window_size, p1.hop,
            p1.n_bins, stream)

    bare3 = functools.partial(
        _build.function("depam_welch_mean", _build.P, _build.P, _build.I,
                        _build.I, _build.I, _build.F, _build.P),
        x3.data_ptr(), out3.data_ptr(), 8, p2.frames_per_record, p2.n_bins,
        welch._inv_n(p2.frames_per_record), stream)
    if hasattr(events, "_plan"):     # the plan raises K6's smem limit
        events._plan(dev, **ev6)
    bare6 = functools.partial(
        _build.function("depam_detect_events", _build.P, _build.P,
                        _build.P, _build.P, _build.I, _build.I, _build.F,
                        _build.F, _build.I, _build.I, _build.P),
        spl6.data_ptr(), pb6.data_ptr(), counts6.data_ptr(),
        rows6.data_ptr(), 8, fpr1, -17.0, 2.0, 1, 16, stream)

    cached = functools.lru_cache(maxsize=16)(lambda p, k, d: None)

    def device_context():
        with torch.cuda.device(dev):
            pass

    ptrs = [out1.data_ptr()] * 8
    pieces = {
        "welch_psd wrapper": lambda: framepsd.welch_psd(x1, p1),
        "welch_psd bare C call": bare1,
        "ct_frame_psd wrapper": lambda: ct_rfft.ct_frame_psd(x2, p2),
        "ct_frame_psd bare C call": bare2,
        "frame_psd wrapper": lambda: framepsd.frame_psd(x1, p1),
        "frame_psd bare C call": bare5,
        "welch_mean wrapper": lambda: welch.welch_mean(x3),
        "welch_mean bare C call": bare3,
        "tol_levels wrapper": lambda: tol.tol_levels(psd4, bm4, p2),
        "tol_levels bare C call": bare4,
        "detect_events wrapper": lambda: events.detect_events(spl6, pb6,
                                                              **ev6),
        "detect_events bare C call": bare6,
        "hash(p)": lambda: hash(p1),
        "lru_cache lookup (p, int, device)": lambda: cached(p1, n, dev),
        "torch.cuda.device(dev) enter + exit": device_context,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes pointer array (8)": lambda: (ctypes.c_void_p * 8)(*ptrs),
        "torch.empty (8, 129) on the card": lambda: torch.empty(
            (8, p1.n_bins), device=dev),
    }

    spin = 10_000_000
    result = {}
    for name, fn in pieces.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(ROUNDS):
            torch.cuda._sleep(spin)
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            rounds.append((time.perf_counter() - t0) / REPS * 1e6)
            torch.cuda.synchronize()
        result[name] = statistics.median(rounds)
        print(f"{args.label}: {name}: {result[name]:.2f} us per call")
    print(json.dumps({"label": args.label, "card": smi,
                      "host_us_per_call": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
