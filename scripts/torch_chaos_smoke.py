#!/usr/bin/env python
"""chaos-smoke for the PyTorch port: the fixed-seed fault-injection
matrix.

The counterpart of ``scripts/chaos_smoke.py``.  Replays deterministic
fault schedules against a small wav corpus across {sync, async} x
{float32, int16} x {unsharded, sharded over two executors} and asserts
the bitwise-or-loud invariant end to end:

  * a healed run (transient reads + sink writes + a straggler, under
    bounded retry) finishes bitwise equal to the fault-free run of the
    same configuration;
  * a quarantined run (a deterministically corrupt record, under
    ``.tolerate``) masks exactly the scheduled record, equals the
    fault-free run on every surviving record, and reports loudly;
  * an unhandled fault fails loudly, naming the fault — never returns;
  * a commit-protocol crash (``crash_after_sidecar``,
    ``crash_before_commit``) leaves a store that a plain resume
    completes bitwise.

Usage: PYTHONPATH=src python scripts/torch_chaos_smoke.py
           [--device cpu|cuda] [--seed N]

``--device cuda`` (the default) runs the jobs on the GPU through the
CUDA kernels; ``--device cpu`` through their plain versions.  The
sharded configurations lay ``.shards(2)`` over a mesh of two executors
on the one device.  Exits non-zero on the first failed check.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import warnings

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import api                                  # noqa: E402
from repro_torch.core.manifest import DatasetManifest        # noqa: E402
from repro_torch.core.params import DepamParams              # noqa: E402
from repro_torch.data.wavio import write_dataset             # noqa: E402
from repro_torch.faults import FaultPlan, FaultSpec          # noqa: E402
from repro_torch.faults.errors import (CorruptRecordError,   # noqa: E402
                                       InjectedCrash)
from repro_torch.launch.mesh import device_mesh              # noqa: E402

P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.25)
M = DatasetManifest(n_files=3, records_per_file=4,
                    record_size=P.record_size, fs=P.fs, seed=11)
FAST = dict(base_delay=0.0, max_delay=0.0, jitter=0.0)
CORRUPT = 6

MATRIX = [dict(payload=pl, sync=sync, shards=sh)
          for sh in (1, 2) for sync in (True, False)
          for pl in ("float32", "int16")]


def label(cfg) -> str:
    return (f"{'sync' if cfg['sync'] else 'async'}/{cfg['payload']}/"
            f"{'unsharded' if cfg['shards'] == 1 else 'sharded'}")


def build(m, p, wavs, cfg, device, store=None):
    """The configuration's job: welch/spl/tol over the wav corpus, four
    records a step; sharded = ``.shards(2)`` over two executors."""
    j = (api.job(m, p).features("welch", "spl", "tol").chunk(4)
         .source(api.WavSource(wavs)).payload(cfg["payload"]))
    if cfg["shards"] > 1:
        j = j.shards(cfg["shards"]).on(
            device_mesh([device] * cfg["shards"]))
    else:
        j = j.device(device)
    if not cfg["sync"]:
        j = j.async_io(depth=2)
    return j if store is None else j.to(store)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chaos-smoke: {what}")


def check_bitwise(got, want, what, skip=()):
    keep = [i for i in range(len(want["spl"])) if i not in skip]
    for name in ("welch", "spl", "tol"):
        check(np.array_equal(np.asarray(got[name])[keep],
                             np.asarray(want[name])[keep]),
              f"{what}: {name} not bitwise")
    if not skip:
        check(np.array_equal(np.asarray(got["mean_welch"]),
                             np.asarray(want["mean_welch"])),
              f"{what}: mean_welch not bitwise")


def caused_by(e: BaseException, cls) -> BaseException | None:
    """The first exception of class ``cls`` on ``e``'s cause chain."""
    while e is not None and not isinstance(e, cls):
        e = e.__cause__
    return e


def run_matrix(m, p, wavs, tmp, device, seed, log=print) -> dict:
    """Every configuration of MATRIX through healed, quarantined, loud
    and both crash points; returns the injected firings per
    configuration."""
    fired = {}
    for n, cfg in enumerate(MATRIX):
        lab = label(cfg)
        want = build(m, p, wavs, cfg, device).run()

        plan = FaultPlan.scheduled(
            seed=seed, n_records=m.n_records, n_steps=3,
            transient_reads=2, sink_writes=1, slow_reads=1,
            slow_s=0.002, transient_times=2)
        got = (build(m, p, wavs, cfg, device, os.path.join(tmp, f"h{n}"))
               .inject(plan).retry(attempts=3, **FAST).run())
        check(plan.stats()["firings"] > 0, f"{lab}: schedule never fired")
        check_bitwise(got, want, f"{lab} healed")
        fired[lab] = plan.stats()["firings"]

        qplan = FaultPlan([FaultSpec("record_corrupt", record=CORRUPT,
                                     times=None)])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            qgot = (build(m, p, wavs, cfg, device).inject(qplan)
                    .tolerate(bad_records=1).run())
        check(qgot.quarantine["records"] == [CORRUPT]
              and "record_corrupt" in qgot.quarantine["reasons"][CORRUPT],
              f"{lab}: quarantine report {qgot.quarantine}")
        check(any("quarantined" in str(w.message) for w in caught),
              f"{lab}: quarantine was silent")
        check(qgot.n_records == want.n_records - 1,
              f"{lab}: {qgot.n_records} records counted")
        check_bitwise(qgot, want, f"{lab} quarantined", skip=(CORRUPT,))

        try:
            build(m, p, wavs, cfg, device).inject(FaultPlan(
                [FaultSpec("record_corrupt", record=CORRUPT,
                           times=None)])).run()
        except CorruptRecordError as e:
            check("record_corrupt" in str(e), f"{lab}: unnamed fault {e}")
        else:
            raise AssertionError(f"chaos-smoke: {lab}: corrupt record "
                                 f"returned silently")

        for kind in ("crash_after_sidecar", "crash_before_commit"):
            store = os.path.join(tmp, f"{kind}-{n}")
            try:
                build(m, p, wavs, cfg, device, store).inject(FaultPlan(
                    [FaultSpec(kind, times=1, after_visits=1)])).run()
            except Exception as e:     # noqa: BLE001 - the chain is checked
                # under async the crash reaches the caller as the
                # AsyncSink's sticky error, chained from the crash
                crash = caused_by(e, InjectedCrash)
                check(crash is not None and kind in str(crash),
                      f"{lab}: {kind} unnamed: {e!r}")
            else:
                raise AssertionError(f"chaos-smoke: {lab}: {kind} never "
                                     f"fired")
            resumed = build(m, p, wavs, cfg, device, store)
            check(resumed.resume_step() == 1,
                  f"{lab}: {kind} left {resumed.resume_step()} steps")
            check_bitwise(resumed.run(), want, f"{lab} {kind} resume")
        log(f"ok  {lab}: healed bitwise ({fired[lab]} firings), "
            f"quarantine accounted, strict loud, both crash points "
            f"resume bitwise")
    return fired


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wavs = os.path.join(tmp, "wavs")
        write_dataset(wavs, M)
        run_matrix(M, P, wavs, tmp, a.device, a.seed)
    print(f"chaos-smoke PASSED: {len(MATRIX)} configs x {{healed, "
          f"quarantined, loud, 2 crash points}}, seed={a.seed}, device="
          f"{a.device}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
