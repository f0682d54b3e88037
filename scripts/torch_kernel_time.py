#!/usr/bin/env python3
"""Device time of the K3 and K6 kernels in one or more source trees, in
turns, on one CUDA GPU.

Run from the root of a checkout:

    python3 scripts/torch_kernel_time.py [--src DIR ...] [--rounds N]

Each ``--src`` names a ``src/`` directory whose ``repro_torch`` is
measured (default: this checkout's); its kernels build into that
tree's own build directory.  Each round runs one process per tree, in
the order given and then reversed in the next round, so that two trees
alternate (a, b, b, a, ...).  A process times, by ``chip_smoke.py``'s
queued-call timing (``queued_ms``): a one-float ``add_``, the least a
queued launch costs; K3 ``welch_mean`` at paper set 2's
step, (8, 80, 2049), and K6 ``detect_events`` on the (SPL, peak bin)
trace of the first 8 records of ``chip_smoke.py``'s detection corpus at
set 1, (8, 15 359), and at set 2, (8, 80); and it checks each against
its plain version (K3 within 1e-5 relative, K6 bitwise).  Prints the
card's name and power limit, one line per process and one JSON line
with every tree's times in every round.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("times the kernels on a CUDA GPU: "
                         "torch.cuda.is_available() is False")
    import chip_smoke as cs
    from repro_torch.core.params import (PARAM_SET_1, PARAM_SET_2,
                                         PCM_DECODE_SCALE)
    from repro_torch.kernels import events, ops, welch

    dev = torch.device("cuda")
    cycles_per_ms = cs.spin_rate()
    # the floor: one queued launch of a kernel that does next to nothing
    tiny = torch.zeros(1, device=dev)
    out = {"add_ (1,)": cs.queued_ms(lambda: tiny.add_(1.0),
                                     cycles_per_ms)[0]}
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    fp = torch.rand(8, PARAM_SET_2.frames_per_record, PARAM_SET_2.n_bins,
                    device=dev, generator=gen)
    got = welch.welch_mean(fp)
    want = welch.welch_mean_plain(fp)
    err = float(((got.double() - want.double()).abs()
                 / (want.double().abs() + 1e-9)).max())
    if err >= 1e-5:
        raise AssertionError(f"K3 disagrees with its plain version: {err}")
    out["welch_mean (8, 80, 2049)"] = cs.queued_ms(
        lambda: welch.welch_mean(fp), cycles_per_ms)[0]
    for name, p in (("set1", PARAM_SET_1), ("set2", PARAM_SET_2)):
        pcm, _scales = cs.corpus(p, 8)
        loud = cs.with_bursts(p, pcm).astype(np.float32)
        x = torch.as_tensor(loud * np.float32(PCM_DECODE_SCALE), device=dev)
        spl, pb = cs.spl_trace(ops.frame_psd(x, p), p)
        kw = dict(threshold_db=cs.EVENT_THRESHOLD_DB,
                  hysteresis_db=cs.EVENT_HYSTERESIS_DB,
                  min_len=p.event_min_len, capacity=p.event_capacity)
        got = events.detect_events(spl, pb, **kw)
        want = events.detect_events_plain(spl.cpu(), pb.cpu(), **kw)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"K6 disagrees with its plain version at "
                                 f"{name}")
        out[f"detect_events {tuple(spl.shape)}"] = cs.queued_ms(
            lambda: events.detect_events(spl, pb, **kw), cycles_per_ms)[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    srcs = args.src or [str(ROOT / "src")]
    if args.child:
        print(json.dumps(child(srcs[0])))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    runs = {src: [] for src in srcs}
    for r in range(args.rounds):
        for src in (srcs if r % 2 == 0 else srcs[::-1]):
            res = subprocess.run(
                [sys.executable, __file__, "--child", "--src", src],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise SystemExit(f"{src}: exit {res.returncode}\n"
                                 f"{res.stdout}\n{res.stderr}")
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[src].append(times)
            print(f"round {r} {src}: " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in times.items()), flush=True)
    print(json.dumps({"card": smi, "device_ms": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
