"""DEPAM pipeline launcher on PyTorch — the paper's job, end to end.

Processes a (synthetic or wav-backed) PAM dataset through the port's
declarative SoundscapeJob API with checkpointed progress, like
submitting the Spark job of the paper:

  PYTHONPATH=src python -m repro_torch.launch.depam_run \
      --param-set 1 --files 8 --record-sec 5 --out /tmp/depam \
      [--device cuda|cpu] \
      [--features welch,spl,tol,percentiles,ltsa,spd,minmax] \
      [--window N | --window per-file] [--wav-dir /path/to/wavs] \
      [--data-root /path/to/real/wavs] [--prefetch-depth 2] [--sync-io] \
      [--payload int16] [--events [--event-threshold-db DB]] \
      [--shards L] [--data-parallel N] \
      [--to store|zarr|netcdf] [--instrument SENS[:GAIN[:VPP]]] \
      [--timestamps auto|none|PATTERN] [--list-features]

The flags, prints, resume behaviour and ``summary.json`` fields are the
reference launcher's (``python -m repro.launch.depam_run``).  The job
runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path
on the CPU instead.

``--to`` picks the output format: ``store`` (the raw resumable
FeatureStore, default), ``zarr`` (a labeled, xarray-openable Zarr
group at ``--out/features.zarr``), or ``netcdf`` (a single labeled
``--out/features.nc``, materialized atomically when the job
completes).  All three are resumable and bitwise-identical.

``--instrument SENS[:GAIN[:VPP]]`` declares the recording chain
(hydrophone sensitivity in dB re 1 V/µPa, preamp gain in dB, ADC
peak-to-peak volts) for wav-fed jobs: calibration gain is derived
from it, it lands in the output attrs, and it is committed with the
resume cursor — resuming under a different instrument is refused.

``--shards L`` fixes a file-aligned partition of L worker slices;
``--data-parallel N`` lays the job over the first N visible CUDA
devices (with ``--device cpu``, over N CPU executors), each owning L/N
slices.  Any N dividing L gives bitwise-identical results, and a run
resumes at another N.  Fewer than N visible devices exits non-zero,
naming the count.

``--timestamps`` controls parsing of per-file UTC start times from the
wav filenames scanned by ``--data-root``: ``auto`` (default) tries the
builtin PAM naming conventions, ``none`` disables parsing, anything
else is a strptime pattern (``%``-style) or a regex with named groups.
When the dataset is timestamped, the absolute UTC coverage window and
total gap duration are printed and recorded in ``summary.json``.

``--events`` turns on transient detection on the device: a ragged
``events`` log (onset, duration, peak bin, peak dB per detection) and
per-event ``impulsive`` metrics (SEL, peak, kurtosis, rise time) land
in the store next to the dense arrays, with their own resume cursor.

``--window`` sets the time resolution of the windowed soundscape
products (``ltsa``/``spd``/``minmax``): an integer groups that many
consecutive records per window, ``per-file`` gives one window per
manifest file, and the default is the whole epoch as one window.

``--list-features`` (or ``--features list``) prints the feature
registry — per-record shape, windowed/epoch outputs, and docs — for the
chosen parameter set, then exits.

``--payload int16`` switches wav-fed jobs to raw-PCM transport: the
readers ship the 2-byte samples as stored (half the host→device bytes,
no host decode pass), calibration rides a per-record sidecar, and the
CUDA kernels dequantize as they load — results stay bitwise-identical
to the default float32 transport.

Dataset selection: the default is a synthetic uniform manifest
(``--files`` x ``--records-per-file``), optionally read from matching
wav files with ``--wav-dir``.  ``--data-root`` instead SCANS a real
directory — heterogeneous file lengths, arbitrary names — and builds
the manifest from the wav headers (``scan_dataset``).

The pipelined executor is on by default: host reads prefetch
``--prefetch-depth`` steps ahead through the SpeculativeLoader,
host<->device copies run on their own CUDA streams through pinned
buffers while earlier steps compute, and store writes/commits ride a
background writer.  ``--sync-io`` forces the fully synchronous loop
(bitwise-identical results).

Resume is implicit: progress is committed to ``--out`` after every step,
so re-running the same command against an existing output directory
picks up from the committed cursor (a "[depam] resuming at step N"
notice is printed).  Delete the output directory to start from scratch.

End-of-job output reports throughput (records/s, GB/min and x-realtime
— seconds of recorded audio processed per wall second).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import api, resolve_device
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2
from repro_torch.core.store import FeatureStore
from repro_torch.distributed.partition import build_partition
from repro_torch.launch.mesh import device_mesh, make_host_mesh


def print_feature_list(m, p) -> None:
    """The registry, self-described: one block per feature with its
    per-record shape, reduction outputs (and their windows), and doc."""
    print(f"registered features (param shapes for nfft={p.nfft}, "
          f"record_sec={p.record_size_sec:g}):")
    for name in api.feature_names():
        spec = api.get_feature(name)
        shape = "reduction-only (nothing stored per record)" \
            if spec.shape is None \
            else f"per-record {(m.n_records,) + tuple(spec.shape(m, p))}"
        print(f"\n  {name}: {spec.doc}")
        print(f"    {shape}")
        for red in spec.reductions:
            win = "the job --window resolution" \
                if red.window.kind == "job" else f"{red.window.key} window"
            out = (red.window.n_windows(m),) + tuple(red.out_shape(m, p)) \
                if red.window.kind != "job" else \
                ("n_windows",) + tuple(red.out_shape(m, p))
            print(f"    -> {red.out_name!r} {out} over {win}"
                  + (f": {red.doc}" if red.doc else ""))


def parse_window(arg: str | None):
    """``--window`` value -> builder kwargs: N records or per-file."""
    if arg is None or arg == "epoch":
        return {}
    if arg in ("per-file", "per_file", "file"):
        return {"per_file": True}
    try:
        return {"records": int(arg)}
    except ValueError:
        raise SystemExit(
            f"--window must be an integer record count, 'per-file', or "
            f"'epoch', got {arg!r}")


def parse_instrument(arg: str):
    """``--instrument SENS[:GAIN[:VPP]]`` -> :class:`api.Instrument`."""
    parts = arg.split(":")
    if not 1 <= len(parts) <= 3:
        raise SystemExit(
            f"--instrument takes SENS[:GAIN[:VPP]], got {arg!r}")
    try:
        sens = float(parts[0])
        gain = float(parts[1]) if len(parts) > 1 else 0.0
        vpp = float(parts[2]) if len(parts) > 2 else 2.0
        return api.Instrument(sensitivity_db=sens, gain_db=gain, vpp=vpp)
    except ValueError as e:
        raise SystemExit(f"--instrument: {e}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.depam_run")
    ap.add_argument("--param-set", type=int, default=1, choices=(1, 2))
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--records-per-file", type=int, default=8)
    ap.add_argument("--record-sec", type=float, default=None,
                    help="override recordSizeInSec (smoke scale)")
    ap.add_argument("--chunk-records", type=int, default=4)
    ap.add_argument("--features", default="welch,spl,tol",
                    help="comma-separated registered features "
                         f"(available: {','.join(api.feature_names())}; "
                         "'list' prints the registry and exits)")
    ap.add_argument("--window", default=None,
                    help="time resolution for windowed reductions "
                         "(ltsa/spd/minmax): an integer groups that "
                         "many records per window, 'per-file' windows "
                         "on manifest file boundaries; default: the "
                         "whole epoch as one window")
    ap.add_argument("--list-features", action="store_true",
                    help="print the feature registry (docs, shapes, "
                         "windowed outputs) and exit")
    ap.add_argument("--out", default=None,
                    help="output/store directory (required unless "
                         "--list-features)")
    ap.add_argument("--wav-dir", default=None,
                    help="read records from manifest-layout wav files "
                         "(written by repro.data.wavio.write_dataset)")
    ap.add_argument("--data-root", default=None,
                    help="scan a REAL wav directory: manifest built "
                         "from the file headers (heterogeneous lengths "
                         "ok; overrides --files/--records-per-file/"
                         "--wav-dir)")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the job runs: 'cuda' (default; raises "
                         "without a CUDA device) or 'cpu' (the plain "
                         "PyTorch path)")
    ap.add_argument("--payload", choices=("float32", "int16"),
                    default="float32",
                    help="host→device payload transport for wav-fed "
                         "jobs: int16 ships raw PCM (half the bus "
                         "bytes, calibration as a sidecar, dequantize "
                         "inside the kernels) with bitwise-identical "
                         "results")
    ap.add_argument("--events", action="store_true",
                    help="detect transient events on-device (adds the "
                         "ragged 'events' log and per-event 'impulsive' "
                         "metrics to the feature set)")
    ap.add_argument("--event-threshold-db", type=float, default=None,
                    help="detection threshold on per-frame wideband SPL "
                         "(dB re 1 uPa^2; default: params)")
    ap.add_argument("--event-hysteresis-db", type=float, default=None,
                    help="close events only below threshold minus this "
                         "(Schmitt trigger; default: params)")
    ap.add_argument("--event-capacity", type=int, default=None,
                    help="max events kept per record (true counts are "
                         "still reported on overflow; default: params)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="run data-parallel over the first N visible "
                         "CUDA devices (a (data=N, model=1) host mesh; "
                         "with --device cpu, N CPU executors); "
                         "default: single-device")
    ap.add_argument("--shards", type=int, default=None,
                    help="logical worker-slice count for the partition "
                         "(must be a multiple of --data-parallel); "
                         "fixing it makes results bitwise-identical "
                         "across device counts — default: one slice "
                         "per data-parallel device")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="plan steps of host read-ahead for the "
                         "pipelined executor (ignored with --sync-io)")
    ap.add_argument("--sync-io", action="store_true",
                    help="disable the pipelined executor (synchronous "
                         "fetch/compute/write; bitwise-identical output)")
    ap.add_argument("--to", dest="fmt", default="store",
                    choices=("store", "zarr", "netcdf"),
                    help="output format: the raw FeatureStore, a "
                         "labeled Zarr group (--out/features.zarr), or "
                         "a labeled NetCDF file (--out/features.nc); "
                         "all resumable, all bitwise-identical")
    ap.add_argument("--instrument", default=None,
                    help="recording chain SENS[:GAIN[:VPP]] — "
                         "hydrophone sensitivity dB re 1 V/uPa, preamp "
                         "gain dB, ADC peak-to-peak volts; derives the "
                         "calibration gain and is committed with the "
                         "resume cursor")
    ap.add_argument("--timestamps", default="auto",
                    help="per-file UTC start parsing for --data-root "
                         "scans: 'auto' (builtin PAM conventions), "
                         "'none', a strptime pattern, or a regex with "
                         "named groups")
    a = ap.parse_args(argv)

    base = PARAM_SET_1 if a.param_set == 1 else PARAM_SET_2
    p = base if a.record_sec is None else dataclasses.replace(
        base, record_size_sec=a.record_sec)
    win_kwargs = parse_window(a.window)
    if a.list_features or a.features.strip() == "list":
        m = DatasetManifest(n_files=a.files,
                            records_per_file=a.records_per_file,
                            record_size=p.record_size, fs=p.fs, seed=42)
        print_feature_list(m, p)
        return
    if a.out is None:
        ap.error("--out is required (unless --list-features)")
    mesh = None
    if a.data_parallel is not None:
        try:
            mesh = device_mesh(["cpu"] * a.data_parallel) \
                if torch.device(a.device).type == "cpu" \
                else make_host_mesh(data=a.data_parallel)
        except ValueError as e:
            ap.error(f"--data-parallel {a.data_parallel}: {e}")
        if a.shards is not None and a.shards % a.data_parallel:
            ap.error(f"--shards {a.shards} is not divisible by "
                     f"--data-parallel {a.data_parallel}: every device "
                     f"must own the same number of worker slices")
    try:
        resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}")
    if a.data_root:
        ts = None if a.timestamps == "none" else a.timestamps
        m = api.scan_dataset(a.data_root, p.record_size, seed=42,
                             timestamps=ts)
        if m.fs != p.fs:
            print(f"[depam] WARNING: dataset is {m.fs:.0f} Hz but param "
                  f"set {a.param_set} assumes {p.fs:.0f} Hz — frequency "
                  f"axes will be off; pick the matching param set")
        counts = [m.records_in_file(i) for i in range(m.n_files)]
        print(f"[depam] scanned {a.data_root}: {m.n_files} files, "
              f"{min(counts)}-{max(counts)} records/file")
    else:
        m = DatasetManifest(n_files=a.files,
                            records_per_file=a.records_per_file,
                            record_size=p.record_size, fs=p.fs, seed=42)
    feats = [f.strip() for f in a.features.split(",") if f.strip()]
    print(f"[depam] param set {a.param_set} (nfft={p.nfft}, "
          f"overlap={p.window_overlap}); dataset {m.n_records} records "
          f"({m.total_gb:.3f} GB); features {feats}")
    coverage = None
    if m.has_timestamps:
        w0, w1 = m.utc_window()
        gap = m.gap_seconds()
        coverage = {"utc_start": api.format_utc(w0),
                    "utc_end": api.format_utc(w1),
                    "gap_seconds": gap}
        print(f"[depam] coverage: {coverage['utc_start']} .. "
              f"{coverage['utc_end']} ({gap:.1f} s of gaps)")

    if a.fmt == "zarr":
        sink = api.ZarrSink(f"{a.out}/features.zarr",
                            chunk_records=a.chunk_records)
    elif a.fmt == "netcdf":
        sink = api.NetCDFSink(f"{a.out}/features.nc")
    else:
        sink = FeatureStore(a.out)
    j = (api.job(m, p).features(*feats).chunk(a.chunk_records)
         .kernels(not a.no_kernels).to(sink).window(**win_kwargs)
         .device(a.device))
    if a.instrument is not None:
        if not (a.data_root or a.wav_dir):
            ap.error("--instrument needs a wav-fed job "
                     "(--wav-dir/--data-root); synthesized records "
                     "carry no recording chain to calibrate")
        inst = parse_instrument(a.instrument)
        j = j.instrument(inst)
        print(f"[depam] instrument: sensitivity "
              f"{inst.sensitivity_db:g} dB re 1 V/uPa, gain "
              f"{inst.gain_db:g} dB, vpp {inst.vpp:g} V "
              f"(linear gain {inst.gain:.6g})")
    if mesh is not None:
        j = j.on(mesh)
        print(f"[depam] mesh: data={a.data_parallel} "
              f"(of {mesh.devices.size} mesh devices)")
    if a.shards is not None:
        if a.shards < 1:
            ap.error(f"--shards must be >= 1, got {a.shards}")
        j = j.shards(a.shards)
        part = build_partition(m, a.shards, a.chunk_records)
        print(f"[depam] partition: {a.shards} worker slices, balance "
              f"ratio {part.balance_ratio:.3f}")
    wav_dir = a.data_root or a.wav_dir
    if wav_dir:
        j = j.source(api.WavSource(wav_dir))
    if a.payload != "float32":
        if not wav_dir:
            ap.error("--payload int16 needs a wav-fed job "
                     "(--wav-dir/--data-root); synthesized records "
                     "never cross the host→device link")
        j = j.payload(a.payload)
    if a.events:
        j = j.events(a.event_threshold_db,
                     hysteresis_db=a.event_hysteresis_db,
                     capacity=a.event_capacity, impulsive=True)
    elif (a.event_threshold_db is not None
          or a.event_hysteresis_db is not None
          or a.event_capacity is not None):
        ap.error("--event-* knobs need --events")
    if not a.sync_io:
        j = j.async_io(depth=a.prefetch_depth)
    mode = "sync" if a.sync_io else \
        f"pipelined (prefetch depth {a.prefetch_depth})"
    print(f"[depam] executor: {mode}; payload {a.payload}")

    start_step = j.resume_step()
    if start_step > 0:
        cur = sink.load_cursor() if a.fmt == "store" \
            else sink.describe().get("committed_records")
        print(f"[depam] resuming at step {start_step} "
              f"(cursor {cur['cursor'] if a.fmt == 'store' else cur})")

    t0 = time.time()
    out = j.run()
    dt = time.time() - t0
    # throughput over the records processed THIS run (a resumed job
    # only recomputes the remaining steps)
    pl_ = out.plan
    done = (pl_.stop - pl_.start) - pl_.committed_records(start_step - 1)
    done_gb = done * m.record_size * 4 / 1e9
    gb_min = done_gb / (dt / 60)
    rec_s = done / dt
    x_rt = done * p.record_size_sec / dt
    summary = (f"[depam] {out.n_records} records in {dt:.1f}s "
               f"({gb_min:.3f} GB/min)")
    if "welch" in out.features:
        summary += f"; welch {out['welch'].shape}"
    if "spl" in out.features:
        summary += f", mean SPL {np.mean(out['spl']):.2f} dB"
    for name, arr in sorted(out.windows.items()):
        summary += f"; {name} {arr.shape}"
    print(summary)
    ev_json = {}
    for name, log in sorted((out.events or {}).items()):
        n_over = int(np.count_nonzero(log.overflow))
        ev_json[name] = {"n_events": log.n_events,
                         "rows_kept": int(log.kept.sum()),
                         "overflowed_records": n_over,
                         "capacity": log.capacity}
        print(f"[depam] {name}: {log.n_events} events across "
              f"{out.n_records} records ({int(log.kept.sum())} rows "
              f"kept, capacity {log.capacity}"
              + (f", {n_over} records overflowed)" if n_over else ")"))
    if a.fmt != "store":
        d = sink.describe()
        mark = f", committed through {d['committed_utc']}" \
            if "committed_utc" in d else ""
        print(f"[depam] output: {d['format']} at {d['path']}{mark}")
    if done == 0:
        # already complete before this run: keep the recorded numbers
        print("[depam] job was already complete; summary.json untouched")
        return
    print(f"[depam] throughput: {rec_s:.2f} records/s, "
          f"{x_rt:.0f}x realtime ({done} records this run)")
    summary_json = {"records": out.n_records, "seconds": dt,
                    "gb": m.total_gb, "gb_per_min": gb_min,
                    "records_per_sec": rec_s, "x_realtime": x_rt,
                    "executor": mode, "payload": a.payload,
                    "features": feats, "window": a.window or "epoch",
                    "windows": {k: list(v.shape)
                                for k, v in sorted(out.windows.items())},
                    "events": ev_json,
                    "output": sink.describe() if a.fmt != "store"
                    else {"format": "store", "path": a.out}}
    if coverage is not None:
        summary_json["coverage"] = coverage
    if a.instrument is not None:
        summary_json["instrument"] = inst.to_state()
    with open(f"{a.out}/summary.json", "w") as f:
        json.dump(summary_json, f, indent=1)


if __name__ == "__main__":
    main()
