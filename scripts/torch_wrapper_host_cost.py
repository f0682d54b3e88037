#!/usr/bin/env python3
"""Host cost of the K1 and K2 launch wrappers of the PyTorch/CUDA port.

Run on a machine with a CUDA GPU, from the root of a checkout:

    python3 scripts/torch_wrapper_host_cost.py [--src DIR] [--label NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that two trees can be compared in one
run.  For ``framepsd.welch_psd`` at paper set 1 ((8, 1 966 080) f32) and
``ct_rfft.ct_frame_psd`` at paper set 2 ((640, 4096) f32) it times, in
host microseconds per call: the whole wrapper, the bare C entry point
with its arguments ready, and the pieces a wrapper may spend its time
on (hashing the parameters, an ``lru_cache`` lookup, entering and
leaving ``torch.cuda.device``, the current stream, a ctypes pointer
array, ``torch.empty``, the block-frames query where the tree has it).
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
    from repro_torch.kernels import _build, ct_rfft, framepsd

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
    n = x1.shape[1]
    fpr1 = (n - p1.window_size) // p1.hop + 1
    stream = torch.cuda.current_stream().cuda_stream
    out1 = torch.empty((8, p1.n_bins), device=dev)
    out2 = torch.empty((640, p2.n_bins), device=dev)

    # The bare C calls, with their arguments ready, for either tree.
    if hasattr(framepsd, "_welch_plan"):
        plan1 = framepsd._welch_plan(p1, n, dev)
        part1 = torch.empty((8, plan1.n_chunks, plan1.cols), device=dev)
        bare1 = functools.partial(
            plan1.f32, x1.data_ptr(), n, n, *plan1.mid, part1.data_ptr(),
            out1.data_ptr(), 8, *plan1.tail, stream)
        plan2 = ct_rfft._plan(p2, dev)
        bare2 = functools.partial(
            plan2.f32, x2.data_ptr(), p2.window_size, *plan2.mid,
            out2.data_ptr(), 640, *plan2.tail, stream)
    else:
        c, s, sc = framepsd._device_constants(p1, fpr1, str(dev))
        blk = _build.function("depam_welch_psd_block_frames",
                              _build.I)(p1.n_bins)
        part1 = torch.empty((8, -(-fpr1 // blk), c.shape[1]), device=dev)
        fn1 = _build.function("depam_welch_psd_f32", _build.P, _build.L,
                              _build.L, *(_build.P,) * 5, *(_build.I,) * 5,
                              _build.P)
        bare1 = functools.partial(
            fn1, x1.data_ptr(), n, n, c.data_ptr(), s.data_ptr(),
            sc.data_ptr(), part1.data_ptr(), out1.data_ptr(), 8, fpr1,
            p1.window_size, p1.hop, p1.n_bins, stream)
        n1 = ct_rfft.default_n1(p2.nfft)
        consts = ct_rfft._device_constants(p2, n1, str(dev))
        arr = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in consts))
        fn2 = _build.function("depam_ct_frame_psd_f32", _build.P, _build.L,
                              ctypes.POINTER(ctypes.c_void_p), _build.P,
                              *(_build.I,) * 5, _build.P)
        bare2 = functools.partial(
            fn2, x2.data_ptr(), p2.window_size, arr, out2.data_ptr(), 640,
            p2.window_size, p2.nfft, n1, p2.n_bins, stream)

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
        "hash(p)": lambda: hash(p1),
        "lru_cache lookup (p, int, device)": lambda: cached(p1, n, dev),
        "torch.cuda.device(dev) enter + exit": device_context,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes pointer array (8)": lambda: (ctypes.c_void_p * 8)(*ptrs),
        "torch.empty (8, 129) on the card": lambda: torch.empty(
            (8, p1.n_bins), device=dev),
    }
    if hasattr(_build.library().lib, "depam_welch_psd_block_frames"):
        blk_fn = _build.function("depam_welch_psd_block_frames", _build.I)
        pieces["depam_welch_psd_block_frames call"] = lambda: blk_fn(129)

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
