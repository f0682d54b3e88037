"""Multi-tenant soundscape service driver on PyTorch — many jobs, one
device.

Launches a :class:`~repro_torch.serve.SoundscapeService` with a fleet of
batch tenants (device-synthesized corpora standing in for wav archives)
and optionally live tenants (ring-buffer streams fed by producer
threads), drives them all concurrently over one device, and reports
per-tenant progress, step latency, and compile-cache reuse:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tenants 3 --live 1 --files 2 --records-per-file 8 \
      --record-sec 0.25 --features welch,spl --chunk 4 \
      [--scheduler drr --weights 1,2,1] [--quantum 2] \
      [--out-root /tmp/svc [--sink-format zarr]] [--verify] \
      [--device cuda|cpu]

The flags and prints are the reference driver's (``python -m
repro.launch.serve``), plus ``--device``: every tenant runs on the CUDA
device (the default; without one the driver exits naming the flag), or
on the CPU with ``--device cpu``.

``--scheduler rr`` (default) is strict round-robin; ``drr`` is
deficit-weighted round-robin with per-tenant ``--weights``.
``--out-root`` gives every tenant its own resumable FeatureStore
directory instead of in-memory arrays; ``--sink-format zarr``
upgrades those to labeled, xarray-openable Zarr groups (the batch
manifest gets synthetic UTC timestamps so the committed
high-watermark is an absolute time), and the per-tenant sink
``describe()`` — output format, path, committed UTC — is surfaced
through ``stats()`` and printed after the drain.  ``--verify``
re-runs each tenant's job solo after the service drains and asserts
the concurrent results are bitwise-identical — the service's core
invariant, demonstrated from the CLI — zarr-sink tenants included
(their results are read back from the labeled chunks).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import threading
import time

import numpy as np

from repro_torch import api, resolve_device
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2
from repro_torch.serve import (DeficitRoundRobin, LiveSource, RoundRobin,
                         SoundscapeService)


def _percentile_ms(seconds: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(seconds), q) * 1e3) \
        if seconds else 0.0


def _bitwise(a, b) -> bool:
    """Bitwise equality of two JobResults across all four namespaces
    (dense features, epoch aggregates, windowed outputs, and the ragged
    event logs — true counts AND kept rows)."""
    for da, db in ((a.features or {}, b.features or {}),
                   (a.epoch, b.epoch), (a.windows, b.windows)):
        if sorted(da) != sorted(db):
            return False
        for k in da:
            if not (np.asarray(da[k]) == np.asarray(db[k])).all():
                return False
    ea, eb = a.events or {}, b.events or {}
    if sorted(ea) != sorted(eb):
        return False
    for k in ea:
        if not ((ea[k].counts == eb[k].counts).all()
                and ea[k].rows.shape == eb[k].rows.shape
                and (ea[k].rows == eb[k].rows).all()):
            return False
    return True


def run(tenants: int = 2, live: int = 0, files: int = 2,
        records_per_file: int = 8, record_sec: float = 0.25,
        features: tuple[str, ...] = ("welch", "spl"), chunk: int = 4,
        quantum: int = 2, scheduler: str = "rr",
        weights: list[float] | None = None, param_set: int = 1,
        out_root: str | None = None, sink_format: str = "store",
        verify: bool = False, seed: int = 0, timeout: float = 600.0,
        device: str = "cuda"):
    """Drive ``tenants`` batch + ``live`` streaming jobs through one
    service; returns ``(results, service)`` with ``results`` mapping
    tenant name -> :class:`~repro_torch.api.job.JobResult`.  Every
    tenant runs on ``device``."""
    if sink_format not in ("store", "zarr"):
        raise SystemExit(f"--sink-format must be store|zarr, "
                         f"got {sink_format!r}")
    if sink_format == "zarr" and out_root is None:
        raise SystemExit("--sink-format zarr needs --out-root")
    base = PARAM_SET_1 if param_set == 1 else PARAM_SET_2
    p = dataclasses.replace(base, record_size_sec=record_sec)
    m = DatasetManifest(n_files=files, records_per_file=records_per_file,
                        record_size=p.record_size, fs=p.fs, seed=42)
    if sink_format == "zarr":
        # synthetic-but-absolute time axis: back-to-back files starting
        # 2010-06-03T12:00:00Z, so the labeled outputs carry real UTC
        # coordinates and stats() can report a committed high-watermark
        span = records_per_file * p.record_size / p.fs
        m = dataclasses.replace(m, file_starts=tuple(
            1275566400.0 + i * span for i in range(files)))
    sched = DeficitRoundRobin() if scheduler == "drr" else RoundRobin()
    svc = SoundscapeService(scheduler=sched, quantum=quantum)
    print(f"[serve] {tenants} batch + {live} live tenants over one "
          f"device; dataset {m.n_records} records x "
          f"{p.record_size} samples; features {list(features)}; "
          f"scheduler {scheduler}, quantum {quantum}")

    def sink_for(name):
        if out_root is None:
            return None
        path = str(pathlib.Path(out_root) / name)
        if sink_format == "zarr":
            return api.ZarrSink(path, chunk_records=chunk)
        return path

    def batch_job():
        return (api.job(m, p).features(*features).chunk(chunk)
                .device(device))

    handles = {}
    for i in range(tenants):
        name = f"batch-{i}"
        w = weights[i] if weights and i < len(weights) else 1.0
        handles[name] = (batch_job().to(sink_for(name))
                        .submit(svc, name=name, weight=w))

    # live tenants: a producer thread pushes pre-generated "acquisition"
    # records through a bounded ring while the service consumes them
    rng = np.random.default_rng(seed)
    live_recs: dict[str, np.ndarray] = {}
    feeders: list[threading.Thread] = []
    for i in range(live):
        name = f"live-{i}"
        recs = rng.standard_normal(
            (m.n_records, p.record_size)).astype(np.float32)
        src = LiveSource(record_size=p.record_size,
                         capacity=max(4 * chunk, 8))
        handles[name] = (batch_job().source(src).to(sink_for(name))
                        .submit(svc, name=name))
        th = threading.Thread(target=src.feed, args=(recs,),
                              name=f"{name}-producer", daemon=True)
        th.start()
        feeders.append(th)
        live_recs[name] = recs

    t0 = time.time()
    svc.run(timeout=timeout)
    dt = time.time() - t0
    for th in feeders:
        th.join()

    results = {name: h.result() for name, h in handles.items()}
    total_records = sum(r.n_records for r in results.values())
    print(f"[serve] drained {len(handles)} tenants "
          f"({total_records} records) in {dt:.2f}s "
          f"({total_records / dt:.1f} records/s aggregate)")
    for name, h in sorted(handles.items()):
        print(f"  {name}: {h.steps_run} steps, "
              f"p50 {_percentile_ms(h.step_seconds, 50):.2f} ms / "
              f"p95 {_percentile_ms(h.step_seconds, 95):.2f} ms per step")
    st = svc.stats()
    cs = st["compile"]
    print(f"[serve] compile cache: step {cs['step']['hits']} hits / "
          f"{cs['step']['misses']} misses, reduce "
          f"{cs['reduce']['hits']} hits / {cs['reduce']['misses']} "
          f"misses ({cs['step']['entries']} step programs for "
          f"{len(handles)} tenants)")
    sinks = {name: info["sink"] for name, info in st["tenants"].items()
             if "sink" in info}
    if sinks:
        print("[serve] sinks:")
        for name, d in sorted(sinks.items()):
            line = f"  {name}: {d['format']} at {d['path']}"
            if "committed_utc" in d:
                line += f" (committed through {d['committed_utc']})"
            print(line)

    if verify:
        for name in sorted(handles):
            j = batch_job()     # fresh in-memory solo run of each job
            if name in live_recs:
                recs = live_recs[name]

                def reader(idx, recs=recs):
                    flat = idx.reshape(-1) % len(recs)
                    return recs[flat].reshape(*idx.shape, -1)
                j = j.source(reader)
            solo = j.run()
            ok = _bitwise(results[name], solo)
            print(f"[serve] verify {name}: "
                  f"{'bitwise-identical' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(
                    f"tenant {name} diverged from its solo run")
    return results, svc


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--tenants", type=int, default=2,
                    help="batch tenants (device-synthesized corpora)")
    ap.add_argument("--live", type=int, default=0,
                    help="live tenants (ring-buffer streams fed by "
                         "producer threads)")
    ap.add_argument("--files", type=int, default=2)
    ap.add_argument("--records-per-file", type=int, default=8)
    ap.add_argument("--record-sec", type=float, default=0.25)
    ap.add_argument("--features", default="welch,spl")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--quantum", type=int, default=2,
                    help="plan steps per scheduling turn")
    ap.add_argument("--scheduler", choices=("rr", "drr"), default="rr")
    ap.add_argument("--weights", default=None,
                    help="comma-separated per-tenant weights (drr)")
    ap.add_argument("--param-set", type=int, default=1, choices=(1, 2))
    ap.add_argument("--out-root", default=None,
                    help="per-tenant FeatureStore directories under "
                         "this root (default: in-memory)")
    ap.add_argument("--sink-format", choices=("store", "zarr"),
                    default="store",
                    help="per-tenant output format under --out-root: "
                         "raw FeatureStore or labeled Zarr groups "
                         "(with a synthetic UTC time axis)")
    ap.add_argument("--verify", action="store_true",
                    help="re-run each tenant solo and assert the "
                         "concurrent results are bitwise-identical")
    ap.add_argument("--device", default="cuda",
                    help="where every tenant runs: 'cuda' (default; "
                         "exits without a CUDA device) or 'cpu'")
    a = ap.parse_args(argv)
    try:
        resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}")
    weights = [float(w) for w in a.weights.split(",")] \
        if a.weights else None
    run(tenants=a.tenants, live=a.live, files=a.files,
        records_per_file=a.records_per_file, record_sec=a.record_sec,
        features=tuple(f.strip() for f in a.features.split(",")
                       if f.strip()),
        chunk=a.chunk, quantum=a.quantum, scheduler=a.scheduler,
        weights=weights, param_set=a.param_set, out_root=a.out_root,
        sink_format=a.sink_format, verify=a.verify, device=a.device)


if __name__ == "__main__":
    main()
