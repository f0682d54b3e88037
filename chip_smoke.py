#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the six hand-written CUDA kernels from ``src/repro_torch/
kernels/csrc`` (nvcc, at first use), holds each against its plain
PyTorch version at the shapes the paper's paths give it -- and K1, K2
and K5 at every shape the CPU tests give them too, K4 at a ragged
block of records, K3 at every shape of SWEEP_K3 and K6 bitwise on
adversarial traces (``k6_traces``) at every case of ``sweep_k6`` --
and drives two paths over one 45-minute paper file for both paper
parameter sets, each under the synchronous and the pipelined executor
(``.sync_io()`` / ``.async_io()``):

  * the main path, ``repro_torch.api.job(m, p).features("welch", "spl",
    "tol", "ltsa")``, checked for agreement with ``scipy.signal.welch``;
  * the detection path, ``.source(api.WavSource(root)).features(
    "percentiles", "spd").events(...)``, read from a wav file that the
    port's ``write_dataset`` writes (a seeded corpus with loud bursts),
    checked for events detected and an overflow flagged once.

On each path and set: float32 and int16 payloads under both executors
are bitwise equal, event logs included; 2 steps into a store and a
resumed run (sync -> sync, async -> sync, sync -> async) equal the
uninterrupted run bitwise; every step after a job's first runs under
``torch.cuda.set_sync_debug_mode("error")``, so a synchronizing call
inside a steady-state step fails the run.  Each job prints its wall,
records/s, x-realtime, peak device memory and its host split (reader
seconds across threads, the engine's per-phase driver seconds, the
sink's write seconds, the prefetcher's task statistics).  Then: the
set-1 detection job's impulsive metrics with the matmul precision set
to "high", against a float64 oracle; one ``torch.profiler`` window of
async steps (device busy share, memcpy totals); and the CLI, ``python
-m repro_torch.launch.depam_run --data-root``, over each set's wav for
both payloads, pipelined and ``--sync-io``, its stored arrays and event
logs held bitwise against the library job, and a rerun that resumes.
Phase 8 runs the paths sharded over repeated executors, phase 9 the
fault layer.  Phase 10 serves five full-width tenants through one
``repro_torch.serve.SoundscapeService`` (set-1 main twice into stores,
set-1 detection into a Zarr group under ``.instrument(...)``, set-2
detection into a NetCDF file, a set-1 ``LiveSource`` stream fed by a
producer thread), each bitwise equal to its job run alone, then a
background-mode drain, a tenant healed after an injected stall, the
device memory after the services are dropped, and ``python -m
repro_torch.launch.serve --verify`` (stores and Zarr).  Phase 11
serves the LM scaffold (``repro_torch.models.lm.LanguageModel``) at
published width: qwen1.5-0.5b (four 512-token prompts and 64 greedy
steps, twice; one 4096-token prompt through both attention branches)
and seamless-m4t-large-v2 over 4096 frames that K5 makes from a paper
record, each checked layer by layer (decode against forward, scanned
against one-shot attention); then the six reduced attention archs on
the card against the CPU.

Launch counters, set to 0 before each path and read after it, show
which kernels each path went through (the service drain's counts are
``service_launches``, phase 11's ``lm_launches``).  Any failed check
raises, so the script exits non-zero and never prints the ``ok`` line.

Output, in order: the card (``nvidia-smi`` name and power limit), the
build, one line per kernel check, per job and per CLI run, a
``{"kernels": [...]}``
JSON line (per kernel: error, kernel / plain / library times and the
least time the card could take, launches on the paths run), and last
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the
reference package, and has no CPU mode: without a CUDA device it exits
non-zero.  Its module-level helpers (the corpus, the detection job, the
timing, the K3 and K6 sweeps and traces) are shared with the scripts in
``scripts/`` and with ``tests/test_torch_*.py``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

FILE_SEC = 45 * 60        # one paper wav file
SEED = 20190315
WARMUP, REPS, ROUNDS = 3, 20, 5

# Detection path: a fixed threshold between the corpus's noise floor
# (about -20.5 dB frame SPL) and its bursts (up to about -4 dB).
EVENT_THRESHOLD_DB, EVENT_HYSTERESIS_DB = -17.0, 2.0
BURST_SEC, BURST_AMP = 0.05, 30000.0
OVERFLOW_RECORD, OVERFLOW_BURSTS = 7, 24      # > event_capacity (16)

# K1, K2 and K5 are also held against their plain versions at every
# shape the CPU tests give them: (nfft, window, overlap) for K1 and K5 --
# the FFT route, and one non-power-of-two nfft on the direct tile -- and
# (nfft, window) for K2.  K4 also runs at SWEEP_K4_RECORDS records, so
# that its last block of records is ragged.
SWEEP_K1 = ((128, 128, 0), (256, 256, 128), (256, 256, 192), (128, 128, 64),
            (512, 384, 288), (256, 128, 64), (320, 320, 160))
SWEEP_K2 = ((1024, 1024), (2048, 2048), (4096, 4096), (8192, 8192),
            (1024, 768))
SWEEP_K5 = ((256, 256, 128), (128, 128, 0), (512, 384, 288), (256, 128, 64),
            (320, 320, 160))
SWEEP_K4_RECORDS = 13
# K3 runs at every (records, frames, bins) of SWEEP_K3, within 1e-5
# relative of its plain version and with the same bits on a second call.
SWEEP_K3 = {"records": (1, 8, 13), "frames": (1, 11, 80, 1000),
            "bins": (129, 2049, 4097)}
# K6 is held bitwise against its plain version (run on CPU copies) on
# k6_traces at SWEEP_K6_RECORDS x these frame counts plus one tile and
# one chunk of the kernel's layout +- 1 frame (sweep_k6): short traces,
# and one trace that crosses several chunks.
SWEEP_K6_RECORDS = (1, 8, 13)
SWEEP_K6_FRAMES = (1, 31, 32, 33, 70001)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 peak, whichever is larger.  Both count the
    function's own work — each input read once, each output written
    once, an FFT's operations for a DFT — not the kernel's algorithm."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def psd_flops(n: int, n_bins: int) -> float:
    """One frame's one-sided PSD: window, a real FFT (~2.5 N log2 N),
    |X|^2 and the scale or frame sum per bin."""
    return n + 2.5 * n * math.log2(n) + 4 * n_bins


def corpus(p, n_records):
    """Seeded int16 PCM (noise std 3000 counts + a tone) and per-record
    decode scales ``PCM_DECODE_SCALE x gain`` (gain 8-12)."""
    import numpy as np
    from repro_torch.core.params import PCM_DECODE_SCALE

    n = p.record_size
    pcm = np.empty((n_records, n), np.int16)
    t = np.arange(n) / p.fs
    for i in range(n_records):
        rng = np.random.default_rng([SEED, i])
        tone = 1000.0 * np.sin(2 * np.pi * (50 + 400 * rng.random()) * t)
        x = rng.standard_normal(n) * 3000.0 + tone
        pcm[i] = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
    gains = np.linspace(8.0, 12.0, n_records).astype(np.float32)
    return pcm, (np.float32(PCM_DECODE_SCALE) * gains).astype(np.float32)


def with_bursts(p, pcm):
    """The corpus plus seeded loud bursts: Hann-windowed tones of
    BURST_SEC, ~10x the noise, 1-3 in three records of four, and
    OVERFLOW_BURSTS in record OVERFLOW_RECORD.  Each burst is centred
    (+-BURST_SEC/4) in a cell of 4096 samples, the analysis frame of
    paper set 2, so that it lies inside one frame of either set."""
    import numpy as np

    n, n_rec, cell = p.record_size, len(pcm), 4096
    length = int(BURST_SEC * p.fs)
    env = BURST_AMP * np.hanning(length)
    t = np.arange(length) / p.fs
    out = pcm.astype(np.float64)
    for i in range(n_rec):
        k = OVERFLOW_BURSTS if i == OVERFLOW_RECORD \
            else (0 if i % 4 == 3 else 1 + i % 3)
        rng = np.random.default_rng([SEED, 1, i])
        for j in range(k):
            centre = (int((j + 0.5) * n / k) // cell + 0.5) * cell
            pos = int(centre - length / 2
                      + rng.integers(-length // 4, length // 4))
            pos = min(max(pos, 0), n - length)
            f = 1000.0 + 3000.0 * rng.random()
            out[i, pos:pos + length] += env * np.sin(2 * np.pi * f * t)
    return np.clip(np.rint(out), -32768, 32767)


def span_ms(fn):
    """Device ms between two CUDA events around ``fn()``."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def spin_rate(spin_cycles=10_000_000):
    """The card's spin rate in cycles per ms, after a first call: that
    one loads the spin kernel's module between the two events and would
    make the spin look slow, the holds of ``queued_ms`` too short and
    its timings host-paced."""
    import torch

    torch.cuda._sleep(spin_cycles)
    torch.cuda.synchronize()
    return spin_cycles / statistics.median(
        span_ms(lambda: torch.cuda._sleep(spin_cycles)) for _ in range(3))


def queued_ms(fn, cycles_per_ms):
    """(device ms, host ms) per call, medians over ROUNDS, and whether
    any round was host-paced.

    Host: wall time of REPS calls with no synchronize, over REPS — what
    one call costs the host to enqueue.  Device: a spin on the card holds
    the stream while the host enqueues REPS calls between two events, so
    the calls run back to back and the span over REPS is device time,
    not launch cost.  A round is host-paced when the spin has already
    ended once the last call is enqueued (a call that synchronizes
    itself, such as a pageable host-to-device copy, always is): its span
    is then the host's pace."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    dev, host, paced = [], [], []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host.append((time.perf_counter() - t0) / REPS * 1e3)
        torch.cuda.synchronize()
        hold_ms = max(4.0 * REPS * host[-1], 1.0)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        spin_end = torch.cuda.Event()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        spin_end.record()
        a.record()
        for _ in range(REPS):
            fn()
        paced.append(spin_end.query())
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / REPS)
    return statistics.median(dev), statistics.median(host), any(paced)


def spl_trace(fp, p):
    """The (SPL dB, peak bin) trace the detection path gives K6, from a
    (records, frames, bins) frame PSD."""
    import torch
    from repro_torch.core import spectra

    return (spectra.db(torch.sum(fp, dim=-1) * p.df, p),
            torch.argmax(fp, dim=-1).to(torch.int32))


def paper_file(p):
    """One 45-min paper file of parameter set ``p``: its manifest, the
    seeded int16 PCM and the per-record decode scales."""
    from repro_torch.core.manifest import DatasetManifest

    n_rec = int(round(FILE_SEC / p.record_size_sec))
    pcm, scales = corpus(p, n_rec)
    m = DatasetManifest(n_files=1, records_per_file=n_rec,
                        record_size=p.record_size, fs=p.fs, seed=SEED)
    return m, pcm, scales


def write_detection_wav(root, p, m, pcm):
    """The detection corpus of one set, ``with_bursts``, written as the
    manifest's wav file under ``root`` by the port's ``write_dataset``."""
    import numpy as np
    from repro_torch.data.wavio import write_dataset

    loud = with_bursts(p, pcm).reshape(-1)
    # + a quarter count away from zero: write_dataset truncates
    # x * 32767 toward zero, so the file holds exactly `loud`
    write_dataset(root, m,
                  gen=lambda fi, n: (loud + 0.25 * np.sign(loud)) / 32767.0)


def detection_job(api, name, p, m, root, payload):
    """The detection path over a set's wav corpus: percentiles and spd
    in 15-minute windows, events at EVENT_THRESHOLD_DB with impulsive
    metrics, on the card."""
    win = 15 if name == "set1" else 90
    return (api.job(m, p).source(api.WavSource(root))
            .features("percentiles", "spd")
            .events(EVENT_THRESHOLD_DB, hysteresis_db=EVENT_HYSTERESIS_DB,
                    impulsive=True)
            .window(records=win).payload(payload).device("cuda"))


class ReadClock:
    """Seconds spent inside wrapped reads, added up across the threads
    that make them (a prefetching source reads on a pool of four)."""

    def __init__(self):
        self.seconds = 0.0
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self.seconds = 0.0

    def time(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        with self._lock:
            self.seconds += time.perf_counter() - t0
        return out

    def wrap(self, fn):
        return lambda idx: self.time(fn, idx)


def impulsive_oracle(x, onset, dur, p):
    """One event's impulsive metrics in float64 numpy: SEL and
    zero-to-peak level (dB), kurtosis, rise time (s), over the event's
    sample span [onset*hop, (onset+dur-1)*hop + window) of record ``x``."""
    import numpy as np

    x = np.asarray(x, np.float64)
    s0 = onset * p.hop
    s1 = min((onset + dur - 1) * p.hop + p.window_size, len(x))
    seg = x[s0:s1]
    e = seg * seg
    sel = 10.0 * np.log10(max(e.sum() / p.fs, 1e-30)) + p.gain_db
    peak = 10.0 * np.log10(max(e.max(), 1e-30)) + p.gain_db
    mean = seg.mean()
    m2 = ((seg - mean) ** 2).mean()
    m4 = ((seg - mean) ** 4).mean()
    return np.array([sel, peak, m4 / max(m2 * m2, 1e-30),
                     float(np.argmax(e)) / p.fs])


def sweep_k6(tile, chunk):
    """K6's sweep cases, (records, frames, min_len, capacity): min_len 1
    and 3 by turns over the frame counts, capacity 16 and 3 by turns
    over the cases, so that both meet short and long traces."""
    frames = sorted(set(SWEEP_K6_FRAMES) | {tile - 1, tile, tile + 1,
                                            chunk - 1, chunk, chunk + 1})
    return [(n_rec, n, 1 + 2 * (i % 2), 3 if (i + j) % 2 else 16)
            for i, n in enumerate(frames)
            for j, n_rec in enumerate(SWEEP_K6_RECORDS)]


def k6_traces(seed, n_rec, n_frames, tile, chunk,
              thr=EVENT_THRESHOLD_DB, hyst=EVENT_HYSTERESIS_DB):
    """Adversarial (spl, peak_bin) traces for K6, numpy float32 / int32
    of shape (n_rec, n_frames), made from ``seed``.

    The background lies below the close level lo = f32(thr) - f32(hyst).
    Record i % 4 == 2 holds one event open from frame 0 to the record
    end (no frame below lo).  The others hold events placed at the
    ``tile`` and ``chunk`` edges of the kernel's layout: ending on the
    frame before an edge (so that they close exactly on a tile's first
    frame), straddling one, or opening on one; record i % 4 == 1 holds
    events of 1-3 frames, more than a capacity keeps.  Event frames
    range over [lo, thr + 6], dips inside the hysteresis band included,
    with a peak tie between the event's second and last frames (in
    different tiles when the event straddles an edge).  On top, at
    random frames of a trace of 8 frames or more (at least one each):
    NaN, +inf, exactly thr, exactly lo, and -inf and the float just
    below lo (closers; not in the open-to-the-end record)."""
    import numpy as np

    f32 = np.float32
    lo = f32(thr) - f32(hyst)
    below = np.nextafter(lo, f32(-np.inf))
    rng = np.random.default_rng([SEED, 6, seed])
    spl = (lo - rng.uniform(0.5, 6.0, (n_rec, n_frames))).astype(f32)
    pb = rng.integers(0, 2049, (n_rec, n_frames)).astype(np.int32)
    if n_frames == 0:
        return spl, pb
    edges = np.unique(np.r_[np.arange(0, n_frames, tile),
                            np.arange(0, n_frames, chunk)])

    def band(n):
        return np.maximum(rng.uniform(lo, thr + 6.0, n).astype(f32), lo)

    for i in range(n_rec):
        row = spl[i]
        if i % 4 == 2:
            row[:] = band(n_frames)
            row[0] = thr
            row[[n_frames // 3, 2 * n_frames // 3]] = f32(thr + 10.0)
        else:
            short = i % 4 == 1
            for e in edges[rng.random(len(edges)) < (0.5 if short else 0.3)]:
                length = int(rng.integers(1, 4 if short else 2 * tile + 1))
                mode = rng.integers(3)
                start = (e - length if mode == 0 else
                         e - int(rng.integers(1, length + 1)) if mode == 1
                         else e)
                start = max(int(start), 0)
                stop = min(start + length, n_frames)
                row[start:stop] = band(stop - start)
                row[start] = thr if rng.random() < 0.5 else f32(thr + 3.0)
                if stop - start >= 3:
                    row[[start + 1, stop - 1]] = f32(thr + 7.0)
        for value, share in ((np.nan, 0.01), (np.inf, 0.002), (thr, 0.01),
                             (lo, 0.01)) + (
                ((-np.inf, 0.002), (below, 0.005)) if i % 4 != 2 else ()):
            k = max(1, int(share * n_frames)) if n_frames >= 8 else 0
            row[rng.integers(0, n_frames, k)] = value
        if i % 4 == 2:
            row[0] = thr
    return spl, pb


def guard_steps(stepper, torch):
    """Run every ``step_once`` of ``stepper`` after its first under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing call
    inside a tenant's steady-state step raises and fails its run."""
    inner = stepper.step_once
    first = [True]

    def step_once():
        if first[0]:
            first[0] = False
            return inner()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    stepper.step_once = step_once


def chip_service(torch):
    """A ``SoundscapeService`` that guards each tenant's steps
    (``guard_steps``), counts its idle turns, and records when each
    tenant finished or was parked (``time.perf_counter``)."""
    from repro_torch.serve import SoundscapeService

    class ChipService(SoundscapeService):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.idle_turns = 0
            self.done_at: dict[str, float] = {}
            self.parked_at: dict[str, float] = {}

        def step(self):
            state = super().step()
            if state == "idle":
                self.idle_turns += 1
            return state

        def _run_quantum(self, tenant):
            if not getattr(tenant.stepper, "_guarded", False):
                guard_steps(tenant.stepper, torch)
                tenant.stepper._guarded = True
            ran = super()._run_quantum(tenant)
            now = time.perf_counter()
            if tenant.state == "done":
                self.done_at.setdefault(tenant.name, now)
            elif tenant.state == "parked":
                self.parked_at.setdefault(tenant.name, now)
            return ran

    return ChipService


def phase10(api, np, torch, sets, wavs, counters, build, detect, all_equal,
            logs_equal, main_results, det_results, expected, det_expected,
            decoded, smi):
    """Phase 10: five full-width tenants through one SoundscapeService on
    the card (DeficitRoundRobin, weights 1, 1, 2, 1, 1, quantum 2), each
    held bitwise against its job run alone; a background-mode drain; a
    healed tenant; the device memory after the service is gone; and the
    serve CLI with ``--verify``.  Returns the drain's launches per
    kernel (counters set to 0 just before it, read just after)."""
    import dataclasses
    import gc

    from scipy.io import netcdf_file
    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.faults.errors import StreamStall
    from repro_torch.serve import DeficitRoundRobin, LiveSource, RestartPolicy

    ChipService = chip_service(torch)
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    d = Path(tmp.name)
    p1, m1, pcm1, scales1 = sets["set1"]
    p2, m2 = sets["set2"][:2]
    inst = api.Instrument(-170.0, gain_db=12.0, vpp=2.0)
    # the detection tenant's file starts at 2010-06-03T12:00:00Z, so its
    # labeled outputs carry UTC coordinates and a committed watermark
    m1_utc = dataclasses.replace(m1, file_starts=(1275566400.0,))
    live_recs = decoded(pcm1, scales1, np.arange(m1.n_records))
    live = LiveSource(record_size=p1.record_size, capacity=16)
    fetch_timeout = live.fetch_timeout
    zarr_path, nc_path = str(d / "det-s1.zarr"), str(d / "det-s2.nc")

    def main_s1(store):
        return build("set1", "float32", store=store).async_io()

    def det_s1(src):
        return (detection_job(api, "set1", p1, m1_utc, wavs["set1"],
                              "float32").source(src))

    def live_job(src):
        return (api.job(m1, p1).features("welch", "spl", "tol").chunk(8)
                .source(src).device("cuda"))

    zarr_sink = api.ZarrSink(zarr_path, chunk_records=8)
    tenants = {
        "main-s1": (main_s1(str(d / "main-s1")), 1.0),
        "main-s1-twin": (main_s1(str(d / "main-s1-twin")), 1.0),
        "det-s1-zarr": (det_s1(api.WavSource(wavs["set1"]))
                        .instrument(inst).to(zarr_sink), 2.0),
        "det-s2-nc": (detect("set2", "float32")
                      .to(api.NetCDFSink(nc_path)), 1.0),
        "live-s1": (live_job(live), 1.0)}
    records = {"main-s1": m1.n_records, "main-s1-twin": m1.n_records,
               "det-s1-zarr": m1.n_records, "det-s2-nc": m2.n_records,
               "live-s1": m1.n_records}
    audio_s = {k: n * (p2 if k == "det-s2-nc" else p1).record_size_sec
               for k, n in records.items()}
    svc = ChipService(scheduler=DeficitRoundRobin(), quantum=2)
    handles = {name: j.submit(svc, name=name, weight=w)
               for name, (j, w) in tenants.items()}

    def produce():
        for i in range(0, len(live_recs), 3):     # pushes of 3 records
            live.push(live_recs[i:i + 3])
        live.end()

    for c in counters.values():
        c.reset()
    producer = threading.Thread(target=produce, name="live-s1-producer")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        producer.start()
        svc.run(timeout=600)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        producer.join()
    seen = {c: counters[c].count for c in counters}
    path_kernels = expected["set1"] | det_expected["set1"] \
        | det_expected["set2"]
    for c, n in seen.items():
        check((n > 0) == (c in path_kernels),
              f"service drain launched {c} {n} times")
    print(f"service drain launches: {seen}")
    results = {name: h.result() for name, h in handles.items()}
    for name, h in handles.items():
        wall = svc.done_at[name] - t0
        st = np.asarray(h.step_seconds) * 1e3
        print(f"tenant {name}: result after {wall:.3f} s, {h.steps_run} "
              f"steps, {records[name] / wall:.2f} records/s, "
              f"{audio_s[name] / wall:.1f} x realtime; host enqueue "
              f"latency per step (step_seconds, not device time) p50 "
              f"{np.percentile(st, 50):.2f} ms, p95 "
              f"{np.percentile(st, 95):.2f} ms ({smi})")
    total = sum(records.values())
    print(f"service drain: {len(handles)} tenants, {total} records in "
          f"{drain_s:.3f} s, {total / drain_s:.2f} records/s, "
          f"{sum(audio_s.values()) / drain_s:.1f} x realtime ({smi})")
    stats = svc.stats()
    host = torch.cuda.host_memory_stats() \
        if hasattr(torch.cuda, "host_memory_stats") else {}
    pinned = {k: v for k, v in host.items() if "bytes" in k}
    print(f"service compile cache {json.dumps(stats['compile'])}; idle "
          f"turns {svc.idle_turns} of {len(svc.trace) + svc.idle_turns}; "
          f"pinned host memory {json.dumps(pinned)}")
    check(stats["compile"]["step"] == {"hits": 1, "misses": 4,
                                       "entries": 4},
          f"compile cache step stats {stats['compile']['step']}: the "
          f"twins must share one step")

    # every tenant against its job run alone (same chunk, no shards)
    solo_live = live_job(api.ReaderSource(
        lambda idx: live_recs[np.asarray(idx) % len(live_recs)])).run()
    solo_det1 = det_s1(api.WavSource(wavs["set1"], calibration=inst)).run()
    solos = {"main-s1": main_results["set1"],
             "main-s1-twin": main_results["set1"],
             "det-s1-zarr": solo_det1, "det-s2-nc": det_results["set2"],
             "live-s1": solo_live}
    for name, want in solos.items():
        got = results[name]
        ok = all_equal(got, want) and (want.events is None
                                       or logs_equal(got, want))
        check(ok, f"tenant {name} != its solo run bitwise")
    check(results["det-s1-zarr"].events["events"].n_events > 0,
          "det-s1-zarr detected no event")

    def same(a, b):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)

    def tables_equal(read, want):
        ok = True
        for ev, cols in (("events", api.EVENT_COLUMNS),
                         ("impulsive", api.IMPULSIVE_COLUMNS)):
            log = want.events[ev]
            ok &= same(read(f"{ev}_counts"), log.counts)
            for i, col in enumerate(cols):
                ok &= same(read(f"{ev}_{col}"), log.rows[:, i])
        return ok and same(read("percentiles"), want["percentiles"]) \
            and same(read("spd"), want["spd"])

    check(tables_equal(
        lambda k: api.read_zarr_array(f"{zarr_path}/{k}"), solo_det1),
        "det-s1-zarr read back != solo arrays")
    with netcdf_file(nc_path, "r", mmap=False) as nc:
        nc_vars = {k: np.array(v[:]) for k, v in nc.variables.items()}
    check(tables_equal(nc_vars.__getitem__, det_results["set2"]),
          "det-s2-nc read back != solo arrays")
    desc = stats["tenants"]["det-s1-zarr"]["sink"]
    check("committed_utc" in desc, f"describe() without committed_utc: "
          f"{desc}")
    print(f"service: 5 tenants bitwise equal to their solo runs (event "
          f"logs included; zarr and netcdf read back); det-s1-zarr "
          f"describe {json.dumps(desc)}")
    del svc, handles, results, tenants, zarr_sink, live

    # background mode: submit from this thread, block on result()
    bg = ChipService(quantum=2).start()
    try:
        t0 = time.perf_counter()
        h = main_s1(str(d / "bg")).submit(bg, name="main-s1")
        res = h.result(timeout=600)
        bg_s = time.perf_counter() - t0
    finally:
        bg.stop()
    check(all_equal(res, main_results["set1"]),
          "background-mode main-s1 != run() bitwise")
    print(f"service background mode: main-s1 result after {bg_s:.3f} s, "
          f"bitwise equal to run() ({smi})")
    del bg, h, res

    # a healed tenant: one injected stall, parked, re-admitted
    class TimedPlan(FaultPlan):
        """The plan, recording when its stall first fired."""
        fired_at = None

        def check_read(self, indices):
            try:
                super().check_read(indices)
            except StreamStall:
                if self.fired_at is None:
                    self.fired_at = time.perf_counter()
                raise

    plan = TimedPlan([FaultSpec("live_stall", record=20, times=1)])
    heal = ChipService(restart=RestartPolicy(restarts=2, base_delay=0.0,
                                             max_delay=0.0, jitter=0.0))
    h = (main_s1(str(d / "healed")).inject(plan)
         .retry(attempts=1, base_delay=0.0, max_delay=0.0, jitter=0.0)
         .submit(heal, name="healed"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        heal.run(timeout=600)
    res = h.result()
    check(h.restarts == 1, f"healed tenant restarts {h.restarts} != 1")
    check(all_equal(res, main_results["set1"]),
          "healed tenant != main-s1 bitwise")
    park_s = heal.parked_at["healed"] - plan.fired_at
    print(f"service healed tenant: injected stall at record 20, parked "
          f"{park_s * 1e3:.2f} ms after the stall fired (a live fetch "
          f"waits fetch_timeout = {fetch_timeout:g} s before its stall), "
          f"1 restart, bitwise equal to main-s1 ({smi})")
    del heal, h, res, plan

    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    check(mem_after == mem_before,
          f"device memory {mem_after} B after the services, {mem_before} "
          f"B before")
    print(f"service: device memory back to {mem_after} B after the "
          f"services and handles were dropped")

    # the serve CLI, store and zarr, each --verify
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for extra in ([], ["--sink-format", "zarr", "--out-root",
                       str(d / "cli-zarr")]):
        args = [sys.executable, "-m", "repro_torch.launch.serve",
                "--tenants", "3", "--live", "1", "--files", "1",
                "--records-per-file", "45", "--record-sec", "60",
                "--chunk", "8", "--verify", *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(args, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"serve CLI {extra} exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        verified = proc.stdout.count("bitwise-identical")
        check(verified == 4, f"serve CLI {extra}: {verified} of 4 tenants "
              f"verified: {proc.stdout[-2000:]}")
        drained = next(ln for ln in proc.stdout.splitlines()
                       if ln.startswith("[serve] drained"))
        print(f"serve CLI {' '.join(extra) or 'store'}: process wall "
              f"{wall:.1f} s; {drained!r}; 4 tenants bitwise-identical "
              f"({smi})")
    tmp.cleanup()
    return seen


# Phase 11: the LM scaffold's serving path (repro_torch.models) at full
# width.  At the reference's init (fan-in along the head axis, so the
# attention is sharply peaked) the full-depth models are chaotic:
# decode against forward, the same math, drifts apart by orders of
# magnitude every few layers, in float32 and in float64 alike
# (scripts/torch_lm_depth_drift.py measures it; ROADMAP C8).  So the
# full-depth checks go layer by layer, every layer fed the same input
# both ways.  A decode step against the forward block: each layer's
# output within 1e-3 relative (scores reach the hundreds at this init,
# so one layer's float32 rounding moves its softmax by up to ~1e-4; a
# wrong formula moves it by O(1)), the logits within the reference's
# test_decode_matches_forward tolerance (rtol 2e-2, atol 2e-3, element
# by element).  The scanned attention branch against the one-shot one:
# each layer and the logits within 1e-4 relative.  Each served model
# also gives the same tokens in two runs.  For the reduced archs the
# card is held to the CPU on the same weights and inputs (11c): within
# 1e-10 in float64, and in float32 within a fixed bound per arch and
# branch, 1e-4 except where the CPU's own float32 error (against its
# float64) is larger than that -- there about 3x the card's recorded
# deviation (readings in the comment of LM_CARD_F32_TOL).
LM_DECODE_RTOL, LM_DECODE_ATOL = 2e-2, 2e-3
LM_LAYER_TOL, LM_BRANCH_TOL = 1e-3, 1e-4
# (arch, batch, prompt tokens, decode steps) served at published width;
# seamless-m4t-large-v2's encoder also takes AUDIO_FRAMES K5 frames, and
# internvl2-1b's prompt sits behind its 256 image tokens.
LM_SERVED = (("qwen1.5-0.5b", 4, 512, 64), ("seamless-m4t-large-v2", 1, 1024,
                                             16),
             ("minicpm3-4b", 4, 512, 16), ("internvl2-1b", 4, 256, 16))
QWEN_LONG = 4096
AUDIO_FRAMES = 4096
LM_PROFILE_STEPS = 8
# 11c: (attn_chunk, batch, tokens): one-shot, and the scanned branch.
LM_CARD_CASES = ((64, 2, 16), (512, 1, 2100))
LM_CARD_F64_TOL, LM_CARD_F32_CAP = 1e-10, 1e-4
# Card float32 against CPU float32, (arch, attn_chunk) where the CPU's
# own float32 error exceeds 1e-4 and the card's deviation from the CPU
# comes near it (NVIDIA H100 80GB HBM3, 700.00 W; worst of forward,
# prefill, decode): CPU error 4.9e-3 / card deviation 1.19e-4
# (internlm2, scanned), 5.1e-4 / 4.72e-4 and 2.5e-2 / 9.63e-4 (seamless,
# one-shot and scanned).  Elsewhere the card stays within 6.4e-5 of the
# CPU (the CPU's own error up to 7.3e-4).
LM_CARD_F32_TOL = {("internlm2-20b", 512): 4e-4,
                   ("seamless-m4t-large-v2", 64): 2e-3,
                   ("seamless-m4t-large-v2", 512): 3e-3}


def lm_batch(cfg, b, s, seed, np):
    """Seeded token prompts (and VLM patches / audio frames) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, 2 * s, cfg.frontend_dim)).astype(np.float32)
    return batch


def rel_err(got, want, n, np):
    got = np.asarray(got.cpu(), np.float64)[..., :n]
    want = np.asarray(want.cpu(), np.float64)[..., :n]
    return float(np.abs(got - want).max() / np.abs(want).max())


def decode_vs_forward(first, full, n, np):
    """(max abs error, max excess over the reference's rtol/atol) of the
    first decode step's logits against forward's, logical vocabulary."""
    a = np.asarray(first.cpu(), np.float64)[..., :n]
    b = np.asarray(full.cpu(), np.float64)[..., :n]
    err = np.abs(a - b)
    return float(err.max()), float(
        (err - (LM_DECODE_ATOL + LM_DECODE_RTOL * np.abs(b))).max())


def serve(torch, model, batch, steps, s_max, n_in):
    """Prefill, then ``steps`` greedy decode steps.  Returns (tokens,
    prefill s, decode s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, s_max)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for i in range(steps):
        tok = torch.argmax(logits[:, : model.cfg.vocab], dim=-1)
        out.append(tok)
        logits, caches = model.decode_step(tok[:, None], caches, n_in + i)
    torch.cuda.synchronize()
    return torch.stack(out, 1), t1 - t0, time.perf_counter() - t1


def forced_decode(np, torch, lm, blocks, model, batch, tok, n_in):
    """Decode against forward layer by layer in ``model``'s precision:
    every layer gets the forward's input for it and runs the forward
    block over the ``n_in`` stack positions + ``tok``, whose cache
    (cut to those positions by the decode's own write at slot
    ``n_in``) feeds one decode step of ``tok``.  Returns (worst layer's
    relative deviation at the new position, the logits' (max abs error,
    excess))."""
    params, cfg, rt = model.tree(), model.cfg, model.rt
    full = dict(batch, tokens=np.concatenate([batch["tokens"], tok], 1))
    with torch.no_grad():
        x, enc = lm.stack_input(params, full, cfg, rt)
        pos = torch.arange(n_in + 1, device=x.device)[None]
        worst = 0.0
        for i in range(cfg.n_layers):
            lp = blocks.layer(params["blocks"], i)
            y, cache = blocks.apply_block(lp, x, cfg, rt, positions=pos,
                                          enc_out=enc)
            yd, _ = blocks.apply_block_decode(lp, x[:, n_in:], cache, n_in,
                                              cfg, rt)
            worst = max(worst, rel_err(yd[:, 0], y[:, -1], None, np))
            x = y
        logits = lm.head(params, x[:, -1], cfg)
        dec = lm.head(params, yd[:, 0], cfg)
    return worst, decode_vs_forward(dec, logits, cfg.vocab, np)


def forced_branches(np, torch, lm, blocks, model, batch, scanned, one_shot):
    """The two attention branches layer by layer: every layer gets the
    one-shot forward's input for it.  Returns (worst layer's relative
    deviation, the last logits' relative deviation)."""
    params, cfg = model.tree(), model.cfg
    with torch.no_grad():
        x, _ = lm.stack_input(params, batch, cfg, one_shot)
        pos = torch.arange(x.shape[1], device=x.device)[None]
        worst = 0.0
        for i in range(cfg.n_layers):
            lp = blocks.layer(params["blocks"], i)
            ys, _ = blocks.apply_block(lp, x, cfg, scanned, positions=pos)
            x, _ = blocks.apply_block(lp, x, cfg, one_shot, positions=pos)
            worst = max(worst, rel_err(ys, x, None, np))
        return worst, rel_err(lm.head(params, ys[:, -1], cfg),
                              lm.head(params, x[:, -1], cfg), cfg.vocab, np)


def device_activity(prof):
    """(device events sorted by start as (start, end, name), device-busy
    us as the union of their intervals, traced span us) of a
    ``torch.profiler`` window; busy is None where it saw no device
    activity."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    on_dev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in evs if e.device_type == DeviceType.CUDA)
    if not on_dev:
        return on_dev, None, None
    busy, end = 0.0, -math.inf
    for a, b, _ in on_dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs))
    return on_dev, busy, span


def profile_decode(torch, model, batch, s_max, n_in):
    """One ``torch.profiler`` window over LM_PROFILE_STEPS greedy decode
    steps after a prefill.  Returns (device operations a step, device
    busy ms, traced ms), the last two None where the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    logits, caches = model.prefill(batch, s_max)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(LM_PROFILE_STEPS):
            tok = torch.argmax(logits[:, : model.cfg.vocab], dim=-1)
            logits, caches = model.decode_step(tok[:, None], caches,
                                               n_in + i)
        torch.cuda.synchronize()
    on_dev, busy, span = device_activity(prof)
    if busy is None:
        return 0.0, None, None
    return len(on_dev) / LM_PROFILE_STEPS, busy / 1e3, span / 1e3


def lm_bounds(lm, module, cfg, rt, batch, tokens, frames, cache_len):
    """(prefill bound ms, decode-step bound ms): the weight matmuls of a
    prefill (2 flops a weight a token; encoder weights a frame) at the
    f32 peak, which leaves attention and the head out; and a decode
    step's bytes -- every weight and every cache entry read once -- at
    the memory rate."""
    defs = lm.param_defs(cfg, rt)
    enc = module.count_params(defs["encoder"]) if "encoder" in defs else 0
    flops = 2 * batch * (tokens * module.count_params(defs["blocks"])
                         + frames * enc)
    per_pos = (cfg.kv_lora_rank + cfg.qk_rope_dim if cfg.mla
               else 2 * cfg.n_kv_heads * cfg.hd)
    kv = cfg.n_layers * batch * per_pos * 4 * (cache_len + frames)
    return (flops / PEAK_F32_FLOPS * 1e3,
            (module.count_params(defs) * 4 + kv) / PEAK_BYTES * 1e3)


def serve_full_width(np, torch, lm, blocks, module, model, batch, steps, smi,
                     frames=0):
    """``model`` at published width: serve ``batch`` twice (the second
    run timed), the same tokens both times; decode against forward layer
    by layer; one profiled window of decode steps.  Prints one line and
    one JSON object; raises past a bound."""
    cfg = model.cfg
    b = batch["tokens"].shape[0]
    extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    n_in = batch["tokens"].shape[1] + extra
    s_max = n_in + steps
    runs = [serve(torch, model, batch, steps, s_max, n_in) for _ in range(2)]
    check(torch.equal(runs[0][0], runs[1][0]),
          f"{cfg.name}: two greedy runs gave different tokens")
    toks, pre_s, dec_s = runs[1]
    peak = torch.cuda.max_memory_allocated()
    layer, (lerr, excess) = forced_decode(
        np, torch, lm, blocks, model, batch, toks[:, :1].cpu().numpy(), n_in)
    check(layer <= LM_LAYER_TOL and excess <= 0,
          f"{cfg.name} layer by layer: decode against forward {layer:.3e} "
          f"relative at the worst layer, logits off by {lerr:.3e}")
    ops_step, busy_ms, span_ms = profile_decode(torch, model, batch, s_max,
                                                n_in)
    n_params = module.count_params(lm.param_defs(cfg, model.rt))
    pre_bound, dec_bound = lm_bounds(lm, module, cfg, model.rt, b, n_in,
                                     frames, s_max)
    positions = b * (n_in + frames)
    busy = ("device busy not measured (the profiler saw no device "
            "activity)" if busy_ms is None else
            f"{ops_step:.1f} device operations a step "
            f"({ops_step / cfg.n_layers:.1f} a layer), device busy "
            f"{busy_ms:.3f} of {span_ms:.3f} ms traced "
            f"({busy_ms / span_ms:.1%})")
    print(f"lm {cfg.name} ({n_params} params, f32, {cfg.padded_vocab}-wide "
          f"logits): B={b} x {n_in} positions"
          + (f" over {frames} encoder frames" if frames else "")
          + f", prefill {pre_s * 1e3:.2f} ms ({positions / pre_s:.1f} "
          f"positions/s), {steps} greedy steps {dec_s * 1e3 / steps:.3f} "
          f"ms/step ({b * steps / dec_s:.1f} tokens/s), bounds "
          f"{pre_bound:.3f} / {dec_bound:.4f} ms, peak "
          f"{peak / 2**30:.3f} GiB; tokens equal over 2 runs; decode vs "
          f"forward layer by layer f32: worst layer {layer:.3e} relative, "
          f"logits max abs err {lerr:.3e}; {LM_PROFILE_STEPS} profiled "
          f"decode steps: {busy} ({smi})")
    print(json.dumps({"lm": cfg.name, "params": n_params, "batch": b,
                      "prompt_positions": n_in, "encoder_frames": frames,
                      "prefill_ms": pre_s * 1e3,
                      "prefill_positions_per_s": positions / pre_s,
                      "decode_ms_per_step": dec_s * 1e3 / steps,
                      "decode_tokens_per_s": b * steps / dec_s,
                      "prefill_bound_ms": pre_bound,
                      "decode_bound_ms": dec_bound,
                      "decode_ops_per_step": ops_step,
                      "decode_device_busy_ms": busy_ms,
                      "decode_traced_ms": span_ms,
                      "decode_vs_forward_layer_rel_f32": layer,
                      "decode_vs_forward_logits_abs_f32": lerr,
                      "peak_bytes": peak, "device": smi}))


def card_vs_cpu(np, torch, arch, chunk, b, s):
    """One reduced attention arch on the card against the CPU, on the
    same seeded weights and inputs: forward's last logits, prefill's and
    the first decode step's, in float64 (within LM_CARD_F64_TOL) and in
    float32 (within LM_CARD_F32_TOL, LM_CARD_F32_CAP where not listed).
    Returns {what: (float64 error, float32 error, the CPU's own float32
    error against its float64)}; raises past a bound."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import RunSpec
    from repro_torch.models import lm, module

    cfg = configs.get(arch, reduced=True)
    rt = RunSpec(attn_chunk=chunk)
    params = module.init(lm.param_defs(cfg, rt), device="cpu",
                         generator=SEED)
    batch = lm_batch(cfg, b, s, SEED, np)
    extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0

    def outputs(device, dtype):
        tree = module.tree_map(lambda t: t.to(device, dtype), params)
        bt = {k: v.astype(np.float64) if dtype == torch.float64
              and v.dtype == np.float32 else v for k, v in batch.items()}
        fwd = lm.forward(tree, bt, cfg, rt)[:, -1]
        prompt = dict(bt, tokens=bt["tokens"][:, :-1])
        pre, caches = lm.prefill(tree, prompt, cfg, rt, s + 4 + extra)
        dec, _ = lm.decode_step(tree, bt["tokens"][:, -1:], caches,
                                s - 1 + extra, cfg, rt)
        return fwd, pre, dec

    with torch.no_grad():
        runs = {(d, t): outputs(d, t) for d in ("cpu", "cuda")
                for t in (torch.float64, torch.float32)}
    f32_tol = LM_CARD_F32_TOL.get((arch, chunk), LM_CARD_F32_CAP)
    out = {}
    for i, what in enumerate(("forward", "prefill", "decode")):
        e64, e32 = (
            rel_err(runs["cuda", t][i], runs["cpu", t][i], cfg.vocab, np)
            for t in (torch.float64, torch.float32))
        noise = rel_err(runs["cpu", torch.float32][i],
                        runs["cpu", torch.float64][i], cfg.vocab, np)
        check(e64 <= LM_CARD_F64_TOL and e32 <= f32_tol,
              f"{arch} reduced {what} (attn_chunk {chunk}): card "
              f"{e64:.3e} (float64, bound {LM_CARD_F64_TOL:.0e}) and "
              f"{e32:.3e} (float32, bound {f32_tol:.0e}) relative from "
              f"the CPU")
        out[what] = (e64, e32, noise)
    return out


def phase11(np, torch, sets, counters, smi):
    """Phase 11: qwen1.5-0.5b, seamless-m4t-large-v2 (over K5 frames of a
    paper record), minicpm3-4b (MLA) and internvl2-1b (the VLM prefix)
    served at their published widths through ``LanguageModel``, seeded
    float32 weights (11a, 11b, 11d); then the attention archs at their
    reduced configs on the card against the CPU (11c).  Returns the
    launches per kernel, counted from the start of the phase to its
    end."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.configs.base import RunSpec
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, lm, module

    for c in counters.values():
        c.reset()

    def served(arch, **over):
        cfg = dataclasses.replace(configs.get(arch), **over)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return lm.LanguageModel(cfg, RunSpec(), device="cuda",
                                generator=SEED)

    cases = {a: (b, s, n) for a, b, s, n in LM_SERVED}
    t_sub = [time.perf_counter()]

    def sub_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - t_sub[0]:.1f} s")
        t_sub[0] = now

    # -- 11a: qwen1.5-0.5b ----------------------------------------------
    b, s, steps = cases["qwen1.5-0.5b"]
    model = served("qwen1.5-0.5b")
    serve_full_width(np, torch, lm, blocks, module, model,
                     lm_batch(model.cfg, b, s, SEED, np), steps, smi)
    long = lm_batch(model.cfg, 1, QWEN_LONG, SEED + 1, np)
    last, times = {}, {}
    one_shot = model.rt
    for chunk in (1024, QWEN_LONG):    # scanned; one shot
        model.rt = dataclasses.replace(one_shot, attn_chunk=chunk)
        model.prefill(long, QWEN_LONG)              # warm-up
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last[chunk], _ = model.prefill(long, QWEN_LONG)
        torch.cuda.synchronize()
        times[chunk] = (time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated())
    free = rel_err(last[1024], last[QWEN_LONG], model.cfg.vocab, np)
    layer, blogits = forced_branches(
        np, torch, lm, blocks, model, long,
        dataclasses.replace(model.rt, attn_chunk=1024), model.rt)
    check(layer <= LM_BRANCH_TOL and blogits <= LM_BRANCH_TOL,
          f"qwen1.5-0.5b {QWEN_LONG}-token prompt layer by layer: scanned "
          f"branch {layer:.3e} relative from one-shot at the worst layer, "
          f"logits {blogits:.3e} (tolerance {LM_BRANCH_TOL})")
    print(f"lm qwen1.5-0.5b one {QWEN_LONG}-token prompt: scanned "
          f"(attn_chunk 1024) prefill {times[1024][0] * 1e3:.2f} ms "
          f"({QWEN_LONG / times[1024][0]:.1f} tokens/s, peak "
          f"{times[1024][1] / 2**30:.3f} GiB), one-shot "
          f"{times[QWEN_LONG][0] * 1e3:.2f} ms "
          f"({QWEN_LONG / times[QWEN_LONG][0]:.1f} tokens/s, peak "
          f"{times[QWEN_LONG][1] / 2**30:.3f} GiB); scanned vs one-shot "
          f"layer by layer f32: worst layer {layer:.3e}, last logits "
          f"{blogits:.3e} relative; free-running last logits {free:.3e} "
          f"(not gated) ({smi})")
    del model, last
    sub_done("11a")

    # -- 11b: seamless-m4t-large-v2 over K5 frames of a paper record -----
    p1, _m1, pcm1, scales1 = sets["set1"]
    record = torch.as_tensor(pcm1[:1].astype(np.float32)
                             * scales1[:1][:, None], device="cuda")
    fp = ops.frame_psd(record, p1)                  # K5: (1, F, n_bins)
    feats = torch.log10(torch.clamp(fp, min=1e-12))
    mu = feats.mean(dim=(1, 2), keepdim=True)
    sd = feats.std(dim=(1, 2), keepdim=True, unbiased=False) + 1e-6
    frames = ((feats - mu) / sd)[:, :AUDIO_FRAMES]
    check(frames.shape == (1, AUDIO_FRAMES, p1.n_bins)
          and bool(torch.isfinite(frames).all()), "audio frames")
    del record, fp, feats
    b, s, steps = cases["seamless-m4t-large-v2"]
    model = served("seamless-m4t-large-v2", frontend_dim=p1.n_bins)
    batch = {"frames": frames,
             "tokens": lm_batch(model.cfg, b, s, SEED + 2, np)["tokens"]}
    serve_full_width(np, torch, lm, blocks, module, model, batch, steps, smi,
                     frames=AUDIO_FRAMES)
    del model, batch, frames
    sub_done("11b")

    # -- 11d: MLA and the VLM prefix ---------------------------------------
    for arch in ("minicpm3-4b", "internvl2-1b"):
        b, s, steps = cases[arch]
        model = served(arch)
        serve_full_width(np, torch, lm, blocks, module, model,
                         lm_batch(model.cfg, b, s, SEED, np), steps, smi)
        del model
    torch.cuda.empty_cache()
    sub_done("11d")

    # -- 11c: the reduced attention archs, card against CPU --------------
    for arch in configs.ARCHS:
        if configs.get(arch, reduced=True).family not in lm.FAMILIES:
            continue
        for chunk, b, s in LM_CARD_CASES:
            errs = card_vs_cpu(np, torch, arch, chunk, b, s)
            print(f"lm {arch} reduced, {b}x{s} tokens, attn_chunk {chunk}: "
                  f"card vs CPU float64 / float32 (CPU float32 vs float64) "
                  + "; ".join(f"{w} {a:.2e} / {c:.2e} ({n:.2e})"
                              for w, (a, c, n) in errs.items()))
    sub_done("11c")

    seen = {c: counters[c].count for c in counters}
    print(f"phase 11 launches: {seen}")
    check(seen["frame_psd"] >= 1 and all(
        n == 0 for c, n in seen.items() if c != "frame_psd"),
          f"phase 11 launched {seen}")
    return seen


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py runs from a checkout of the "
                         "repository: src/repro_torch is missing")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py measures the port on a CUDA GPU and "
                         "has no CPU mode: torch.cuda.is_available() is "
                         "False")

    import scipy.signal

    from repro_torch import api
    from repro_torch.core import spectra
    from repro_torch.core.params import (PARAM_SET_1, PARAM_SET_2,
                                         PCM_DECODE_SCALE, DepamParams)
    from repro_torch.core.manifest import DatasetManifest
    from repro_torch.core.store import FeatureStore
    from repro_torch.core.tol import band_matrix
    from repro_torch.core.windows import make_window
    from repro_torch.data.wavio import BlockReader, write_dataset
    from repro_torch.kernels import (_build, ct_rfft, events, framepsd, ops,
                                     tol as tolk, welch as welchk)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    phase_t = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

    t0 = time.perf_counter()
    lib = _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds}) -> {lib.path.name}")

    # -- data: one 45-min file per set, int16 PCM + per-record scales --
    sets = {}
    for name, p in (("set1", PARAM_SET_1), ("set2", PARAM_SET_2)):
        t0 = time.perf_counter()
        m, pcm, scales = paper_file(p)
        sets[name] = (p, m, pcm, scales)
        print(f"{name}: {m.n_records} records x {p.record_size} samples "
              f"made in {time.perf_counter() - t0:.2f} s")

    # the detection corpus: the same PCM plus bursts, one wav file per set
    (ROOT / "build").mkdir(exist_ok=True)
    wav_tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    wavs = {}
    for name, (p, m, pcm, _scales) in sets.items():
        t0 = time.perf_counter()
        root = str(Path(wav_tmp.name) / name)
        write_detection_wav(root, p, m, pcm)
        wavs[name] = root
        print(f"{name}: wav with bursts written in "
              f"{time.perf_counter() - t0:.2f} s "
              f"({Path(root, m.file_name(0)).stat().st_size / 1e6:.1f} MB)")

    def decoded(pcm, scales, idx):
        return pcm[idx].astype(np.float32) * scales[idx][:, None]

    phase_done("1 (build, data)")

    # -- phase 2: each kernel against its plain version ---------------------
    cycles_per_ms = spin_rate()
    print(f"spin: {cycles_per_ms:.0f} cycles per ms")

    def time_ms(fn):
        return queued_ms(fn, cycles_per_ms)

    def max_rel(a, b, floor):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / (b.abs() + floor)).max())

    report = []

    def once_ms(fn):
        """(span ms, host ms) of ONE call: for a plain version that is
        a long loop of small launches, where REPS calls would take
        minutes.  The card waits on the host between those launches, so
        the span between the two events is host-paced wall time, not
        device time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_ms = span_ms(fn)
        return dev_ms, (time.perf_counter() - t0) * 1e3

    def record(name, source, replaces, got, want, kernel, plain, library,
               n_bytes, flops, plain_once=False):
        b_ms, b_by = bound_ms(n_bytes, flops)
        k_ms, k_host, k_paced = time_ms(kernel)
        p_ms, p_host, p_paced = (*once_ms(plain), True) if plain_once \
            else time_ms(plain)
        l_ms, l_host, l_paced = (None, None, False) if library is None \
            else time_ms(library)
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,
            "max_abs_err": max(
                float((g.double() - w.double()).abs().max())
                for g, w in (zip(got, want) if isinstance(got, tuple)
                             else [(got, want)])),
            "ms": k_ms, "plain_ms": p_ms,
            "plain_timing": ("one call, host-paced wall" if plain_once
                             else "device, queued calls"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "host_paced": {"ms": k_paced, "plain_ms": p_paced,
                           "library_ms": l_paced}})
        print(f"{name}: device ms={k_ms:.5f} plain_ms={p_ms:.5f}"
              + (" (one call, host-paced wall)" if plain_once else "")
              + f" library_ms={l_ms} bound_ms={b_ms:.5f} ({b_by}, "
              f"{b_ms / k_ms:.1%} of it)")
        print(f"{name}: host ms per call (enqueue): kernel={k_host:.5f} "
              f"plain={p_host:.5f} library={l_host}; host-paced: "
              f"kernel={k_paced} plain={p_paced} library={l_paced}")

    idx8 = np.arange(8)
    # K1 welch_psd: set 1, one step of 8 records
    p1, _m1, pcm1, sc1 = sets["set1"]
    q1 = torch.as_tensor(pcm1[idx8], device=dev)
    s1 = torch.as_tensor(sc1[idx8], device=dev)
    x1 = torch.as_tensor(decoded(pcm1, sc1, idx8), device=dev)
    k1 = framepsd.welch_psd(x1, p1)
    k1_plain = framepsd.welch_psd_plain(x1, p1)
    k1_q = framepsd.welch_psd(q1, p1, s1)
    torch.cuda.synchronize()
    err = max_rel(k1, k1_plain, 1e-9)
    print(f"K1 welch_psd {tuple(x1.shape)} -> {tuple(k1.shape)}: max rel "
          f"err {err:.3e} (tol 1e-4), int16 == float32 bitwise: "
          f"{torch.equal(k1, k1_q)}")
    check(err < 1e-4, "K1 disagrees with its plain version")
    check(torch.equal(k1, k1_q), "K1 int16 call differs from float32 call")
    w1 = make_window(p1.window, p1.window_size, device=dev)
    sc1_bins = torch.as_tensor(framepsd._bin_scale(p1)[0], device=dev)
    fpr1 = p1.frames_per_record
    n1_bins = p1.n_bins
    record("welch_psd", "src/repro_torch/kernels/csrc/framepsd.cu",
           "src/repro/kernels/framepsd.py:239", k1, k1_plain,
           lambda: framepsd.welch_psd(x1, p1),
           lambda: framepsd.welch_psd_plain(x1, p1),
           lambda: (torch.fft.rfft(
               x1.unfold(-1, p1.window_size, p1.hop) * w1, n=p1.nfft)
               .abs().square().mean(dim=-2) * sc1_bins),
           n_bytes=(x1.numel() + k1.numel()) * 4,
           flops=8 * fpr1 * psd_flops(p1.nfft, n1_bins))

    # K2 ct_frame_psd: set 2, one step of 8 records = 640 frames
    p2, _m2, pcm2, sc2 = sets["set2"]
    x2 = torch.as_tensor(decoded(pcm2, sc2, idx8), device=dev)
    q2 = torch.as_tensor(pcm2[idx8], device=dev)
    fr2 = x2.unfold(-1, p2.window_size, p2.hop).reshape(-1, p2.window_size)
    fq2 = q2.unfold(-1, p2.window_size, p2.hop).reshape(-1, p2.window_size)
    fpr2 = p2.frames_per_record
    fs2 = torch.as_tensor(np.repeat(sc2[idx8], fpr2), device=dev)
    k2 = ct_rfft.ct_frame_psd(fr2, p2)
    k2_plain = ct_rfft.ct_frame_psd_plain(fr2, p2)
    k2_q = ct_rfft.ct_frame_psd(fq2, p2, scales=fs2)
    torch.cuda.synchronize()
    err = max_rel(k2, k2_plain, 1e-6)
    print(f"K2 ct_frame_psd {tuple(fr2.shape)} -> {tuple(k2.shape)}: max "
          f"rel err {err:.3e} (tol 1e-3, floor 1e-6), int16 == float32 "
          f"bitwise: {torch.equal(k2, k2_q)}")
    check(err < 1e-3, "K2 disagrees with its plain version")
    check(torch.equal(k2, k2_q), "K2 int16 call differs from float32 call")
    w2 = make_window(p2.window, p2.window_size, device=dev)
    bscale2 = (spectra.onesided_weights(p2.nfft, device=dev)
               * spectra.periodogram_scale(p2))
    record("ct_frame_psd", "src/repro_torch/kernels/csrc/ct_rfft.cu",
           "src/repro/kernels/ct_rfft.py:122", k2, k2_plain,
           lambda: ct_rfft.ct_frame_psd(fr2, p2),
           lambda: ct_rfft.ct_frame_psd_plain(fr2, p2),
           lambda: (torch.fft.rfft(fr2 * w2, n=p2.nfft).abs().square()
                    * bscale2),
           n_bytes=(fr2.numel() + k2.numel()) * 4,
           flops=fr2.shape[0] * psd_flops(p2.nfft, p2.n_bins))

    # K3 welch_mean: the set-2 step's per-frame PSD, (8, 80, 2049)
    fp3 = k2.reshape(8, fpr2, p2.n_bins)
    k3 = welchk.welch_mean(fp3)
    k3_plain = welchk.welch_mean_plain(fp3)
    torch.cuda.synchronize()
    err = max_rel(k3, k3_plain, 1e-9)
    print(f"K3 welch_mean {tuple(fp3.shape)} -> {tuple(k3.shape)}: max rel "
          f"err {err:.3e} (tol 1e-5)")
    check(err < 1e-5, "K3 disagrees with its plain version")
    record("welch_mean", "src/repro_torch/kernels/csrc/welch.cu",
           "src/repro/kernels/welch.py:32", k3, k3_plain,
           lambda: welchk.welch_mean(fp3),
           lambda: welchk.welch_mean_plain(fp3),
           lambda: torch.mean(fp3, dim=1),
           n_bytes=(fp3.numel() + k3.numel()) * 4, flops=fp3.numel())

    # K4 tol_levels: both sets' Welch PSDs of the step's 8 records, and
    # of SWEEP_K4_RECORDS records (a ragged block of records); timed at
    # set 2 (8, 2049)
    idx4 = np.arange(SWEEP_K4_RECORDS)
    cases4 = ((p1, k1), (p2, k3),
              (p1, framepsd.welch_psd(torch.as_tensor(
                  decoded(pcm1, sc1, idx4), device=dev), p1)),
              (p2, ops.welch_psd(torch.as_tensor(
                  decoded(pcm2, sc2, idx4), device=dev), p2)))
    bm2 = torch.as_tensor(band_matrix(p2), device=dev)
    for p, psd in cases4:
        bm = torch.as_tensor(band_matrix(p), device=dev)
        got4 = tolk.tol_levels(psd, bm, p)
        want4 = tolk.tol_levels_plain(psd, bm, p)
        again4 = tolk.tol_levels(psd, bm, p)
        torch.cuda.synchronize()
        err = float((got4 - want4).abs().max())
        print(f"K4 tol_levels {tuple(psd.shape)} x {tuple(bm.shape)}: max "
              f"abs err {err:.3e} dB (tol 1e-4), same bits on a second "
              f"call: {torch.equal(got4, again4)}")
        check(err < 1e-4, f"K4 disagrees with its plain version at "
              f"{tuple(psd.shape)}")
        check(torch.equal(got4, again4), "K4 is not deterministic")
    del cases4
    k4 = tolk.tol_levels(k3, bm2, p2)
    k4_plain = tolk.tol_levels_plain(k3, bm2, p2)
    nb, nbands = bm2.shape
    record("tol_levels", "src/repro_torch/kernels/csrc/tol.cu",
           "src/repro/kernels/tol.py:29", k4, k4_plain,
           lambda: tolk.tol_levels(k3, bm2, p2),
           lambda: tolk.tol_levels_plain(k3, bm2, p2),
           lambda: (10.0 * torch.log10(torch.clamp(
               (k3 @ bm2) * p2.df, min=1e-30)) + p2.gain_db),
           n_bytes=(8 * nb + nb * nbands + 8 * nbands) * 4,
           flops=2 * 8 * int(torch.count_nonzero(bm2)) + 3 * 8 * nbands)

    def wav_step(name):
        """The first step (8 records) of a set's detection corpus, read
        from its wav file as the detection path reads it: raw int16 PCM
        and per-record decode scales."""
        reader = BlockReader(wavs[name], sets[name][1], raw=True)
        q = torch.as_tensor(reader(idx8), device=dev)
        s = torch.as_tensor(reader.scales_for(idx8), device=dev)
        reader.close()
        return q, s

    # K5 frame_psd: the set-1 step of the detection corpus (float32 and
    # raw int16)
    q5, s5 = wav_step("set1")
    x5 = q5.float() * s5[:, None]
    k5 = framepsd.frame_psd(x5, p1)
    k5_plain = framepsd.frame_psd_plain(x5, p1)
    k5_q = framepsd.frame_psd(q5, p1, s5)
    torch.cuda.synchronize()
    err = max_rel(k5, k5_plain, 1e-9)
    route5 = framepsd._frame_plan(p1, dev).route
    print(f"K5 frame_psd {tuple(x5.shape)} -> {tuple(k5.shape)}: route "
          f"{route5}, max rel err {err:.3e} (tol 5e-4, floor 1e-9), int16 "
          f"== float32 bitwise: {torch.equal(k5, k5_q)}")
    check(route5 == "fft", "K5 does not take the FFT route at set 1")
    check(err < 5e-4, "K5 disagrees with its plain version")
    check(torch.equal(k5, k5_q), "K5 int16 call differs from float32 call")
    record("frame_psd", "src/repro_torch/kernels/csrc/framepsd.cu",
           "src/repro/kernels/framepsd.py:130", k5, k5_plain,
           lambda: framepsd.frame_psd(x5, p1),
           lambda: framepsd.frame_psd_plain(x5, p1),
           lambda: (torch.fft.rfft(
               x5.unfold(-1, p1.window_size, p1.hop) * w1, n=p1.nfft)
               .abs().square() * sc1_bins),
           n_bytes=(x5.numel() + k5.numel()) * 4,
           flops=8 * fpr1 * psd_flops(p1.nfft, n1_bins))

    # K6 detect_events: on the SPL and peak-bin trace of each set's
    # detection step, from K5's output at set 1 and K2's at set 2, as
    # the detection path builds it; recorded at set 1
    q6, s6 = wav_step("set2")
    traces = {"set1": spl_trace(k5, p1),
              "set2": spl_trace(ops.frame_psd(q6, p2, scales=s6), p2)}
    del x5, q5, k5, k5_plain, k5_q, q6, s6
    for name, (spl6, pb6) in traces.items():
        p = sets[name][0]
        ev_kw = dict(threshold_db=EVENT_THRESHOLD_DB,
                     hysteresis_db=EVENT_HYSTERESIS_DB,
                     min_len=p.event_min_len, capacity=p.event_capacity)
        k6 = events.detect_events(spl6, pb6, **ev_kw)
        k6_plain = events.detect_events_plain(spl6, pb6, **ev_kw)
        torch.cuda.synchronize()
        same6 = all(torch.equal(a, b) for a, b in zip(k6, k6_plain))
        counts6 = k6[0].tolist()
        print(f"K6 detect_events {name} {tuple(spl6.shape)} -> counts "
              f"{counts6}, rows {tuple(k6[1].shape)}: == plain version "
              f"bitwise: {same6}")
        check(same6, f"K6 disagrees with its plain version at {name}")
        check(sum(counts6) > 0 and max(counts6) > p.event_capacity,
              f"K6 {name} step found no events or no overflow")
        k6_bytes = (spl6.numel() + pb6.numel() + k6[0].numel()
                    + k6[1].numel()) * 4
        if name == "set1":
            record("detect_events", "src/repro_torch/kernels/csrc/events.cu",
                   "src/repro/kernels/events.py:137", k6, k6_plain,
                   lambda: events.detect_events(spl6, pb6, **ev_kw),
                   lambda: events.detect_events_plain(spl6, pb6, **ev_kw),
                   None, n_bytes=k6_bytes, flops=0, plain_once=True)
        else:
            # 80 frames a record: the plain loop is short enough for
            # time_ms's queued calls
            k_ms, k_host, k_paced = time_ms(
                lambda: events.detect_events(spl6, pb6, **ev_kw))
            p_ms, p_host, p_paced = time_ms(
                lambda: events.detect_events_plain(spl6, pb6, **ev_kw))
            b_ms, b_by = bound_ms(k6_bytes, 0)
            print(f"detect_events {name} {tuple(spl6.shape)}: device "
                  f"ms={k_ms:.5f} plain_ms={p_ms:.5f} bound_ms={b_ms:.7f} "
                  f"({b_by}); host ms per call: kernel={k_host:.5f} "
                  f"plain={p_host:.5f}; host-paced: kernel={k_paced} "
                  f"plain={p_paced}")
    del traces

    phase_done("2")

    # -- phase 2b: K1, K2 and K5 at every shape the CPU tests give them ----
    rng = np.random.default_rng(SEED)

    def pcm_and_scales(shape):
        q = np.clip(np.rint(rng.standard_normal(shape) * 3000), -32768,
                    32767).astype(np.int16)
        sc = (PCM_DECODE_SCALE * rng.uniform(0.5, 2.0, shape[0])).astype(
            np.float32)
        return (torch.as_tensor(q, device=dev), torch.as_tensor(sc, device=dev),
                torch.as_tensor(q.astype(np.float32) * sc[:, None],
                                device=dev))

    def sweep_params(nfft, window, overlap, n_frames):
        hop = window - overlap
        return DepamParams(nfft=nfft, window_size=window,
                           window_overlap=overlap,
                           record_size_sec=((n_frames - 1) * hop + window)
                           / 32768.0)

    for nfft, window, overlap in SWEEP_K1:
        p = sweep_params(nfft, window, overlap, 1000)
        q, sc, x = pcm_and_scales((4, p.record_size))
        got, got_q = framepsd.welch_psd(x, p), framepsd.welch_psd(q, p, sc)
        err = max_rel(got, framepsd.welch_psd_plain(x, p), 1e-9)
        torch.cuda.synchronize()
        print(f"K1 sweep nfft={nfft} window={window} overlap={overlap} "
              f"{tuple(x.shape)}: max rel err {err:.3e} (tol 1e-4), int16 == "
              f"float32 bitwise: {torch.equal(got, got_q)}")
        check(err < 1e-4, f"K1 disagrees with its plain version at {nfft}, "
              f"{window}, {overlap}")
        check(torch.equal(got, got_q),
              f"K1 int16 != float32 at {nfft}, {window}, {overlap}")
    for nfft, window in SWEEP_K2:
        p = sweep_params(nfft, window, 0, 2)
        q, sc, x = pcm_and_scales((300, window))
        got, got_q = ct_rfft.ct_frame_psd(x, p), ct_rfft.ct_frame_psd(
            q, p, scales=sc)
        err = max_rel(got, ct_rfft.ct_frame_psd_plain(x, p), 1e-6)
        same_n1 = torch.equal(got, ct_rfft.ct_frame_psd(
            x, p, n1=ct_rfft.default_n1(nfft) // 2))
        torch.cuda.synchronize()
        print(f"K2 sweep nfft={nfft} window={window} {tuple(x.shape)}: max "
              f"rel err {err:.3e} (tol 1e-3, floor 1e-6), int16 == float32 "
              f"bitwise: {torch.equal(got, got_q)}, n1 does not change the "
              f"bits: {same_n1}")
        check(err < 1e-3, f"K2 disagrees with its plain version at {nfft}, "
              f"{window}")
        check(torch.equal(got, got_q), f"K2 int16 != float32 at {nfft}")
        check(same_n1, f"K2 result depends on n1 at {nfft}")
    for nfft, window, overlap in SWEEP_K5:
        p = sweep_params(nfft, window, overlap, 1000)
        q, sc, x = pcm_and_scales((3, p.record_size))
        got, got_q = framepsd.frame_psd(x, p), framepsd.frame_psd(q, p, sc)
        row, row_q = framepsd.frame_psd(x[1], p), framepsd.frame_psd(
            q[1], p, sc[1])
        err = max(max_rel(got, framepsd.frame_psd_plain(x, p), 1e-9),
                  max_rel(row, framepsd.frame_psd_plain(x[1], p), 1e-9))
        route = framepsd._frame_plan(p, dev).route
        torch.cuda.synchronize()
        same_q = torch.equal(got, got_q) and torch.equal(row, row_q)
        same_row = torch.equal(row, got[1])
        print(f"K5 sweep nfft={nfft} window={window} overlap={overlap} "
              f"{tuple(x.shape)}: route {route}, max rel err {err:.3e} (tol "
              f"5e-4, floor 1e-9, 1-D and 2-D), int16 == float32 bitwise: "
              f"{same_q}, 1-D call == its row: {same_row}")
        check(route == ("fft" if nfft in (128, 256, 512) else "direct"),
              f"K5 takes the {route} route at {nfft}, {window}")
        check(err < 5e-4, f"K5 disagrees with its plain version at {nfft}, "
              f"{window}, {overlap}")
        check(same_q, f"K5 int16 != float32 at {nfft}, {window}, {overlap}")
        check(same_row, f"K5 1-D call != its row at {nfft}, {window}")

    # K3 at every shape of SWEEP_K3: 1e-5 relative, the same bits twice
    for n_rec in SWEEP_K3["records"]:
        for n_frames in SWEEP_K3["frames"]:
            for n_bins in SWEEP_K3["bins"]:
                fp = torch.rand(n_rec, n_frames, n_bins, device=dev)
                got, again = welchk.welch_mean(fp), welchk.welch_mean(fp)
                err = max_rel(got, welchk.welch_mean_plain(fp), 1e-9)
                check(err < 1e-5, f"K3 disagrees with its plain version at "
                      f"{tuple(fp.shape)}: {err:.3e}")
                check(torch.equal(got, again),
                      f"K3 is not deterministic at {tuple(fp.shape)}")
    del fp, got, again    # out of the paths' peak device memory
    n3 = math.prod(len(v) for v in SWEEP_K3.values())
    print(f"K3 sweep: {n3} shapes (records "
          f"{SWEEP_K3['records']} x frames {SWEEP_K3['frames']} x bins "
          f"{SWEEP_K3['bins']}) within 1e-5 relative, the same bits on a "
          f"second call")

    # K6 on adversarial traces at every case of sweep_k6, bitwise against
    # its plain version on CPU copies
    tile, chunk = events.TILE_FRAMES, events.CHUNK_FRAMES
    cases6 = sweep_k6(tile, chunk)
    overflowed = 0
    t0 = time.perf_counter()
    for i, (n_rec, n_frames, min_len, cap) in enumerate(cases6):
        spl, pb = k6_traces(i, n_rec, n_frames, tile, chunk)
        kw = dict(threshold_db=EVENT_THRESHOLD_DB,
                  hysteresis_db=EVENT_HYSTERESIS_DB, min_len=min_len,
                  capacity=cap)
        got = events.detect_events(torch.as_tensor(spl, device=dev),
                                   torch.as_tensor(pb, device=dev), **kw)
        want = events.detect_events_plain(torch.as_tensor(spl),
                                          torch.as_tensor(pb), **kw)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"K6 disagrees with its plain version on the sweep trace "
              f"({n_rec}, {n_frames}), min_len {min_len}, capacity {cap}")
        overflowed += int((want[0] > cap).sum())
    del got
    check(overflowed > 0, "the K6 sweep overflowed no capacity")
    print(f"K6 sweep: {len(cases6)} cases (records {SWEEP_K6_RECORDS} x "
          f"frames {sorted({c[1] for c in cases6})}; tile {tile}, chunk "
          f"{chunk}; min_len 1/3, capacity 16/3) == plain version bitwise, "
          f"{overflowed} records over capacity, in "
          f"{time.perf_counter() - t0:.1f} s")

    phase_done("2b")

    # -- phase 3: the main path, under both executors ------------------------
    counters = ops.launch_counters()
    feats = ("welch", "spl", "tol", "ltsa")
    clock = ReadClock()

    class TimedWavSource(api.WavSource):
        """WavSource whose reads add their seconds to ``clock``."""

        def fetch(self, indices):
            return clock.time(super().fetch, indices)

    class TimedMemorySink(api.MemorySink):
        """MemorySink that adds up the seconds its writes take, on the
        thread that makes them (an AsyncSink's writer, or the driver)."""

        def __init__(self):
            super().__init__()
            self.seconds = 0.0

        def write(self, step, indices, values):
            t0 = time.perf_counter()
            super().write(step, indices, values)
            self.seconds += time.perf_counter() - t0

        def write_events(self, step, indices, values):
            t0 = time.perf_counter()
            super().write_events(step, indices, values)
            self.seconds += time.perf_counter() - t0

    def f32_reader(pcm, scales):
        def read(idx):
            idx = np.asarray(idx)
            flat = idx.reshape(-1)
            out = np.zeros((flat.size, pcm.shape[1]), np.float32)
            live = flat < len(pcm)
            out[live] = decoded(pcm, scales, flat[live])
            return out.reshape(idx.shape + (pcm.shape[1],))
        return read

    def i16_reader(pcm):
        def read(idx):
            idx = np.asarray(idx)
            flat = idx.reshape(-1)
            out = np.zeros((flat.size, pcm.shape[1]), np.int16)
            live = flat < len(pcm)
            out[live] = pcm[flat[live]]
            return out.reshape(idx.shape + (pcm.shape[1],))
        return read

    def i16_scales(scales):
        return lambda idx: scales[np.minimum(np.asarray(idx),
                                             len(scales) - 1)]

    def build(name, payload, store=None, limit=None):
        p, m, pcm, scales = sets[name]
        if payload == "int16":
            src = api.ReaderSource(clock.wrap(i16_reader(pcm)),
                                   payload_dtype="int16",
                                   scales=i16_scales(scales))
        else:
            src = api.ReaderSource(clock.wrap(f32_reader(pcm, scales)))
        win = 15 if name == "set1" else 90     # 15-minute LTSA panels
        j = (api.job(m, p).features(*feats).window(records=win)
             .source(src).device("cuda").limit(limit))
        return j.to(store) if store is not None else j

    def run(label, name, j, sink):
        """Drive job ``j`` (whose sink is ``sink``) through its stepper,
        every step after the first under
        ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing
        call inside a steady-state step raises and fails the run.  Prints
        the wall, records/s, x-realtime, peak device memory and the host
        split; returns the result and the split."""
        p = sets[name][0]
        clock.reset()
        st = j._stepper()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            st.start()
            st.step_once()
            torch.cuda.set_sync_debug_mode("error")
            try:
                while st.step_once():
                    pass
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out = st.finish()
        finally:
            st.close()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        res = api.JobResult(features=out[0], epoch=out[1], windows=out[2],
                            window_edges=out[3], n_records=out[4],
                            events=out[5], plan=out[6])
        n = res.n_records
        print(f"job {label}: {n} records in {dt:.3f} s, {n / dt:.2f} "
              f"records/s, {n * p.record_size_sec / dt:.1f} x realtime, "
              f"peak device memory {peak_gb:.3f} GB")
        split = {"wall_s": dt, "steps": st.pl.n_steps,
                 "read_s": clock.seconds,
                 **{f"{k}_s": v for k, v in st.host_seconds.items()},
                 "sink_write_s": sink.seconds,
                 "prefetch": getattr(st.source, "last_stats", None)}
        print(f"host split {label}: {json.dumps(split)}")
        return res, split

    def same(a, b):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)

    def all_equal(ra, rb):
        names = list(ra.features) + list(ra.epoch) + list(ra.windows)
        return all(same(ra[k], rb[k]) for k in names)

    launches = {c: 0 for c in counters}
    executors = {"sync": lambda j: j.sync_io(), "async": lambda j: j.async_io()}

    def drive(path, name, make, expected, equal):
        """One path at one set, through ``make(name, payload, store,
        limit)``: a warm-up step; the float32 job under the synchronous
        executor, with every count set to 0 just before it and read just
        after; then float32 async and int16 sync and async, each ==
        float32 sync bitwise; then 2 steps into a store and a resumed
        run, for sync -> sync, async -> sync and sync -> async, each ==
        uninterrupted bitwise.  Returns the float32 sync result and the
        warnings its run issued."""
        label = f"{name} {path}"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            make(name, "float32", limit=1).run()        # warm-up step
        results, reads = {}, {}
        for payload in ("float32", "int16"):
            for ex, mode in executors.items():
                first = (payload, ex) == ("float32", "sync")
                for c in counters.values():
                    c.reset()
                sink = TimedMemorySink()
                with warnings.catch_warnings(record=first) as caught_now:
                    if first:
                        warnings.simplefilter("always")
                    else:
                        warnings.simplefilter("ignore", RuntimeWarning)
                    res, split = run(f"{label} {payload} {ex}", name,
                                     mode(make(name, payload)).to(sink),
                                     sink)
                seen = {c: counters[c].count for c in counters}
                print(f"{label} {payload} {ex} launches: {seen}")
                if first:
                    caught = caught_now
                    for c, n in seen.items():
                        launches[c] += n
                        check((n > 0) == (c in expected),
                              f"{label} launched {c} {n} times")
                else:
                    check(all(seen[c] > 0 for c in expected),
                          f"{label} {payload} {ex} run missed a kernel")
                results[(payload, ex)] = res
                reads[(payload, ex)] = split["read_s"]
        base = results[("float32", "sync")]
        for key, res in results.items():
            check(equal(base, res), f"{label} {key} != float32 sync bitwise")
        print(f"{label}: float32 and int16 payloads x sync and async "
              f"executors all bitwise equal")
        print(f"{label}: host decode (float32 read - int16 read, sync): "
              f"{reads[('float32', 'sync')] - reads[('int16', 'sync')]:.4f}"
              f" s")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for first, second in (("sync", "sync"), ("async", "sync"),
                                  ("sync", "async")):
                with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
                    executors[first](make(name, "float32", store=d,
                                          limit=2)).run()
                    j = make(name, "float32", store=d)
                    check(j.resume_step() == 2,
                          f"{label} store did not commit 2 steps")
                    check(equal(base, executors[second](j).run()),
                          f"{label} {first} limit 2 + {second} resume != "
                          f"uninterrupted run bitwise")
                print(f"{label}: {first} (limit 2) + {second} resume == "
                      f"uninterrupted bitwise")
        return base, caught

    expected = {"set1": {"welch_psd", "tol_levels"},
                "set2": {"ct_frame_psd", "welch_mean", "tol_levels"}}
    main_results = {}
    for name in ("set1", "set2"):
        p, m, pcm, scales = sets[name]
        res, _ = drive("main", name, build, expected[name], all_equal)
        main_results[name] = res
        n_bins = p.n_bins
        check(res["welch"].shape == (m.n_records, n_bins)
              and res["ltsa"].shape == (3, n_bins)
              and res["mean_welch"].shape == (n_bins,),
              f"{name} output shapes")
        for k in ("welch", "spl", "tol", "ltsa", "mean_welch"):
            check(bool(np.isfinite(res[k]).all()), f"{name} {k} not finite")

        tol = 1e-4 if name == "set1" else 1e-3
        floor = 1e-9 if name == "set1" else 1e-6
        for i in range(2):
            x64 = decoded(pcm, scales, np.array([i]))[0].astype(np.float64)
            _f, want = scipy.signal.welch(
                x64, fs=p.fs, window=p.window, nperseg=p.window_size,
                noverlap=p.window_overlap, nfft=p.nfft, detrend=False,
                scaling="density", return_onesided=True)
            got = res["welch"][i].astype(np.float64)
            err = float(np.max(np.abs(got - want) / (np.abs(want) + floor)))
            print(f"{name} record {i} vs scipy.signal.welch (float64): max "
                  f"rel err {err:.3e} (tol {tol:g})")
            check(err < tol, f"{name} record {i} disagrees with scipy")

    phase_done("3")

    # -- phase 4: the detection path, read from the wav files ----------------
    det_expected = {"set1": {"frame_psd", "detect_events"},
                    "set2": {"ct_frame_psd", "detect_events"}}

    def detect(name, payload, store=None, limit=None):
        p, m = sets[name][:2]
        j = (detection_job(api, name, p, m, wavs[name], payload)
             .source(TimedWavSource(wavs[name])).limit(limit))
        return j.to(store) if store is not None else j

    def logs_equal(ra, rb):
        return sorted(ra.events) == sorted(rb.events) and all(
            same(ra.events[k].counts, rb.events[k].counts)
            and same(ra.events[k].rows, rb.events[k].rows)
            for k in ra.events)

    det_results = {}
    for name in ("set1", "set2"):
        p, m = sets[name][:2]
        res, caught = drive(
            "detection", name, detect, det_expected[name],
            lambda ra, rb: all_equal(ra, rb) and logs_equal(ra, rb))
        det_results[name] = res
        ev, imp = res.events["events"], res.events["impulsive"]
        warned = [w for w in caught
                  if "event capacity overflow" in str(w.message)]
        print(f"{name} detection: {ev.n_events} events kept in "
              f"{int((ev.counts > 0).sum())} of {m.n_records} records, "
              f"max count {int(ev.counts.max())} (capacity {ev.capacity}), "
              f"overflow in records {np.flatnonzero(ev.overflow).tolist()}, "
              f"{len(warned)} overflow warning(s); event logs included in "
              f"every bitwise check")
        check(ev.n_events > 0, f"{name} detected no event")
        check(bool(ev.overflow.any()) and len(warned) == 1,
              f"{name} overflow not flagged once")
        check(np.array_equal(ev.counts, imp.counts)
              and bool(np.isfinite(imp.rows).all()),
              f"{name} impulsive rows")
        n_win = -(-m.n_records // (15 if name == "set1" else 90))
        check(res["percentiles"].shape == (m.n_records, 7, p.n_bins)
              and bool(np.isfinite(res["percentiles"]).all())
              and res["spd"].shape == (n_win, p.n_bins, 60)
              and bool(np.isfinite(res["spd"]).all()),
              f"{name} detection output shapes")

    phase_done("4")

    # -- phase 5: the impulsive einsums under matmul precision "high" --------
    # TF32 is a process-wide setting the port does not pin for its own
    # torch matmuls; hold the set-1 detection job's impulsive metrics, run
    # with it allowed, against a float64 oracle at the CPU test's
    # tolerances (sel, peak 1e-3 dB; kurtosis 1e-3 rel + 1e-3; rise 2/fs)
    p, m = sets["set1"][:2]
    torch.set_float32_matmul_precision("high")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res_hi = detect("set1", "float32").run()
    finally:
        torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "matmul precision not restored")
    reader = BlockReader(wavs["set1"], m)
    for label, res in (("highest", det_results["set1"]), ("high", res_hi)):
        ev, imp = res.events["events"], res.events["impulsive"]
        errs = np.zeros(4)
        for i in range(m.n_records):
            x = reader(np.array([i]))[0]
            for row, got in zip(ev.record(i), imp.record(i)):
                want = impulsive_oracle(x, int(row[0]), int(row[1]), p)
                errs = np.maximum(errs, np.abs(got - want) / np.array(
                    [1.0, 1.0, max(abs(want[2]), 1.0), 1.0]))
        print(f"impulsive set1 under matmul precision {label!r}: "
              f"{ev.n_events} events, max err sel {errs[0]:.3e} dB, peak "
              f"{errs[1]:.3e} dB, kurtosis {errs[2]:.3e} (relative above "
              f"1), rise {errs[3]:.3e} s (tol 1e-3, 1e-3, 1e-3, "
              f"{2.0 / p.fs:.3e})")
        check(errs[0] < 1e-3 and errs[1] < 1e-3 and errs[2] < 1e-3
              and errs[3] <= 2.0 / p.fs,
              f"impulsive metrics under precision {label!r} off the "
              f"float64 oracle")
    reader.close()
    del res_hi

    phase_done("5")

    # -- phase 6: one profiled window of async steps -------------------------
    from torch.profiler import ProfilerActivity, profile

    sink = TimedMemorySink()
    st = detect("set1", "float32").to(sink).async_io()._stepper()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            st.start()
            st.step_once()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                while st.step_once():
                    pass
                st.finish()
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
    finally:
        st.close()
    on_dev, busy, span = device_activity(prof)
    if on_dev:
        memcpy = {}
        for a, b, nm in on_dev:
            kind = next((k for k in ("HtoD", "DtoH", "DtoD") if k in nm),
                        None) if "Memcpy" in nm else None
            if kind is not None:
                n, us = memcpy.get(kind, (0, 0.0))
                memcpy[kind] = (n + 1, us + b - a)
        print(f"profile set1 detection float32 async, {st.pl.n_steps - 1} "
              f"steps after the first ({window_s:.3f} s wall): device busy "
              f"{busy / 1e3:.3f} ms of the {span / 1e3:.3f} ms traced "
              f"({busy / span:.1%}); memcpy "
              + ", ".join(f"{k} {n} calls {us / 1e3:.3f} ms"
                          for k, (n, us) in sorted(memcpy.items())))
    else:
        print("profile set1 detection float32 async: the profiler recorded "
              "no device activity; device busy share not measured")

    phase_done("6")

    # -- phase 7: the CLI on the card -----------------------------------------
    fields = {"records", "seconds", "gb", "gb_per_min", "records_per_sec",
              "x_realtime", "executor", "payload", "features", "window",
              "windows", "events", "output"}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli_tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")

    def cli(name, payload, mode):
        p = sets[name][0]
        out = str(Path(cli_tmp.name) / f"{name}-{payload}-{mode}")
        args = [sys.executable, "-m", "repro_torch.launch.depam_run",
                "--data-root", wavs[name], "--param-set", name[-1],
                "--features", "percentiles,spd", "--events",
                f"--event-threshold-db={EVENT_THRESHOLD_DB}",
                f"--event-hysteresis-db={EVENT_HYSTERESIS_DB}",
                "--window", "15" if name == "set1" else "90",
                "--chunk-records", "8", "--payload", payload, "--out", out]
        if mode == "sync":
            args.append("--sync-io")
        t0 = time.perf_counter()
        proc = subprocess.run(args, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"CLI {name} {payload} {mode} exited {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        store = FeatureStore(out)
        stored = {"percentiles": np.load(f"{out}/percentiles.npy"),
                  "spd": np.load(f"{out}/spd.npy")}
        for ev_name, cols in (("events", api.EVENT_COLUMNS),
                              ("impulsive", api.IMPULSIVE_COLUMNS)):
            stored[ev_name] = store.load_events(ev_name, len(cols))
        return out, proc.stdout, wall, stored

    def stored_equal(stored, res):
        return (same(stored["percentiles"], res["percentiles"])
                and same(stored["spd"], res["spd"])
                and all(same(stored[k][0], res.events[k].counts)
                        and same(stored[k][1], res.events[k].rows)
                        for k in ("events", "impulsive")))

    for name in ("set1", "set2"):
        for payload in ("float32", "int16"):
            for mode in ("pipelined", "sync"):
                out, log, wall, stored = cli(name, payload, mode)
                with open(f"{out}/summary.json") as f:
                    summary = json.load(f)
                check(set(summary) == fields,
                      f"CLI summary.json fields {sorted(summary)}")
                check(stored_equal(stored, det_results[name]),
                      f"CLI {name} {payload} {mode} arrays != library job")
                print(f"CLI {name} {payload} {mode}: process wall "
                      f"{wall:.1f} s, job {summary['seconds']:.3f} s, "
                      f"{summary['records_per_sec']:.2f} records/s, "
                      f"{summary['x_realtime']:.1f} x realtime, executor "
                      f"{summary['executor']!r}; stored arrays and event "
                      f"logs == library job bitwise")
        if name == "set1":
            out, log, wall, stored = cli(name, "int16", "pipelined")
            check("[depam] resuming at step" in log
                  and stored_equal(stored, det_results[name]),
                  f"CLI rerun did not resume or changed its arrays: {log}")
            notice = next(ln for ln in log.splitlines() if "resuming" in ln)
            print(f"CLI {name} int16 pipelined rerun: {notice!r}; arrays "
                  f"unchanged")
    cli_tmp.cleanup()
    phase_done("7")

    # -- phase 8: sharded execution over repeated executors ------------------
    from repro_torch.launch.mesh import device_mesh

    def result_of(out):
        return api.JobResult(features=out[0], epoch=out[1], windows=out[2],
                             window_edges=out[3], n_records=out[4],
                             events=out[5], plan=out[6], quarantine=out[7])

    def stepped(j):
        """Drive job ``j`` through its stepper, every step after the
        first under ``set_sync_debug_mode("error")``; returns the result
        and the wall seconds."""
        st = j._stepper()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            st.start()
            st.step_once()
            torch.cuda.set_sync_debug_mode("error")
            try:
                while st.step_once():
                    pass
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out = st.finish()
        finally:
            st.close()
        torch.cuda.synchronize()
        return result_of(out), time.perf_counter() - t0

    # the five-file corpus at the full 60 s records: the partition cuts
    # on file boundaries
    p1 = PARAM_SET_1
    m5 = DatasetManifest.from_files((3, 6, 3, 4, 4),
                                    record_size=p1.record_size, fs=p1.fs,
                                    seed=SEED)
    t0 = time.perf_counter()
    root5 = str(Path(wav_tmp.name) / "set1x5")
    write_dataset(root5, m5)
    print(f"set1x5: {m5.n_records} records in {m5.n_files} wav files "
          f"written in {time.perf_counter() - t0:.2f} s")

    def five(name, payload):
        return (api.job(m5, p1).features(*feats).window(records=15)
                .source(TimedWavSource(root5)).payload(payload)
                .device("cuda"))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        unsharded5 = five("set1x5", "float32").run()

    def close_main(got, want, rel, db):
        err = {}
        for k in ("welch", "ltsa", "mean_welch"):
            g, w = (np.asarray(x, np.float64) for x in (got[k], want[k]))
            err[k] = float(np.max(np.abs(g - w) / np.abs(w)))
        for k in ("spl", "tol"):
            err[k] = float(np.max(np.abs(np.asarray(got[k], np.float64)
                                         - np.asarray(want[k]))))
        ok = all(err[k] < (rel if k in ("welch", "ltsa", "mean_welch")
                           else db) for k in err)
        return ok, err

    def close_detection(got, want, rel, db):
        err = {"percentiles": float(np.max(np.abs(
            got["percentiles"].astype(np.float64) - want["percentiles"]))),
            "spd": float(np.max(np.abs(got["spd"] - want["spd"])))}
        ge, we = got.events["events"], want.events["events"]
        gi, wi = got.events["impulsive"], want.events["impulsive"]
        same_rows = (np.array_equal(ge.counts, we.counts)
                     and np.array_equal(ge.rows[:, :3], we.rows[:, :3])
                     and np.array_equal(gi.counts, wi.counts))
        if same_rows:
            err["peak_db"] = float(np.max(np.abs(ge.rows[:, 3]
                                                 - we.rows[:, 3])))
            d = np.abs(gi.rows.astype(np.float64) - wi.rows)
            err["sel_peak_db"] = float(d[:, :2].max())
            err["kurtosis"] = float(np.max(d[:, 2] / np.maximum(
                np.abs(wi.rows[:, 2]), 1.0)))
            err["rise_s"] = float(d[:, 3].max())
        ok = (same_rows and err["percentiles"] < db and err["spd"] < 1e-3
              and err["peak_db"] < db and err["sel_peak_db"] < db
              and err["kurtosis"] < 1e-3
              and err["rise_s"] <= 2.0 / sets["set1"][0].fs)
        return ok, err

    sets["set1x5"] = (p1, m5, None, None)
    sharded_launches = {c: 0 for c in counters}
    shard_jobs = (
        ("set1 main", "set1", build, expected["set1"], all_equal,
         main_results["set1"], close_main, (1e-4, 1e-3)),
        ("set1x5 main", "set1x5", five, expected["set1"], all_equal,
         unsharded5, close_main, (1e-4, 1e-3)),
        ("set1 detection", "set1", detect, det_expected["set1"],
         lambda ra, rb: all_equal(ra, rb) and logs_equal(ra, rb),
         det_results["set1"], close_detection, (5e-4, 1e-3)),
        ("set2 detection", "set2", detect, det_expected["set2"],
         lambda ra, rb: all_equal(ra, rb) and logs_equal(ra, rb),
         det_results["set2"], close_detection, (1e-3, 5e-3)))
    for (label, name, make, expect, equal, unsharded, close,
         tols) in shard_jobs:
        p, m = sets[name][:2]
        audio_s = m.n_records * p.record_size_sec
        results, walls = {}, {}

        def sharded_job(payload, mode, d, store=None, limit=None):
            j = make(name, payload).shards(4).chunk(2)
            if d is not None:
                j = j.on(device_mesh([dev] * d))
            j = mode(j)
            if store is not None:
                j = j.to(store).limit(limit)
            return j

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for payload in ("float32", "int16"):
                for ex, mode in executors.items():
                    for d in (None, 1, 2, 4):
                        counted = (payload, ex, d) == ("float32", "sync", 4)
                        for c in counters.values():
                            c.reset()
                        res, wall = stepped(sharded_job(payload, mode, d))
                        seen = {c: counters[c].count for c in counters}
                        if counted:
                            for c, n in seen.items():
                                sharded_launches[c] += n
                                check((n > 0) == (c in expect),
                                      f"sharded {label} launched {c} {n} "
                                      f"times")
                            print(f"sharded {label} float32 sync D=4 "
                                  f"launches: {seen}")
                        else:
                            check(all(seen[c] > 0 for c in expect),
                                  f"sharded {label} {payload} {ex} D={d} "
                                  f"missed a kernel")
                        results[(payload, ex, d)] = res
                        walls[(payload, ex, d)] = wall
                    with tempfile.TemporaryDirectory(
                            dir=ROOT / "build") as sd:
                        stepped(sharded_job(payload, mode, 4, sd, 2))
                        j = sharded_job(payload, mode, 2, sd)
                        check(j.resume_step() == 2,
                              f"sharded {label} store did not commit 2 "
                              f"steps")
                        res, _ = stepped(j)
                        results[(payload, ex, "D=4 -> D=2 resume")] = res
        base = results[("float32", "sync", None)]
        for key, res in results.items():
            check(equal(base, res),
                  f"sharded {label} {key} != no-mesh float32 sync bitwise")
        ok, err = close(base, unsharded, *tols)
        print(f"sharded {label}: no mesh, D=1, 2, 4 and D=4 -> D=2 resume "
              f"x float32/int16 x sync/async: {len(results)} runs bitwise "
              f"equal, event logs included, steady-state steps under "
              f"set_sync_debug_mode('error'); against the unsharded job "
              f"{json.dumps(err)} (tol {tols[0]:g} rel, {tols[1]:g} dB)")
        check(ok, f"sharded {label} off the unsharded job: {err}")
        for d in (None, 1, 2, 4):
            where = "no mesh" if d is None else f"D={d}"
            for payload in ("float32", "int16"):
                for ex in executors:
                    w = walls[(payload, ex, d)]
                    print(f"sharded {label} {where} "
                          f"{payload} {ex}: {m.n_records} records in "
                          f"{w:.3f} s, {m.n_records / w:.2f} records/s, "
                          f"{audio_s / w:.1f} x realtime ({smi})")
    del sets["set1x5"]
    phase_done("8")

    # -- phase 9: the fault layer on the card -------------------------------
    import importlib.util
    from repro_torch.faults import FaultPlan

    spec = importlib.util.spec_from_file_location(
        "torch_chaos_smoke", ROOT / "scripts" / "torch_chaos_smoke.py")
    chaos = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chaos)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        root_c = str(Path(d) / "wavs")
        write_dataset(root_c, chaos.M)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            fired = chaos.run_matrix(chaos.M, chaos.P, root_c, d, "cuda", 7,
                                     log=lambda s: print(f"chaos {s}"))
    print(f"chaos matrix on the card: {len(fired)} configurations, "
          f"{sum(fired.values())} injected firings healed bitwise")

    p, m = sets["set1"][:2]
    n_steps = -(-m.n_records // 8)
    plan = FaultPlan.scheduled(seed=7, n_records=m.n_records,
                               n_steps=n_steps, transient_reads=2,
                               sink_writes=1, transient_times=2)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        healed = (build("set1", "float32").to(d).inject(plan)
                  .retry(attempts=3, base_delay=0.0, max_delay=0.0,
                         jitter=0.0).run())
        check(plan.stats()["firings"] > 0, "45-min healed job never fired")
        check(all_equal(healed, main_results["set1"]),
              "45-min healed job != fault-free run bitwise")
    print(f"healed set1 main on the 45-min file: {plan.stats()} == "
          f"fault-free bitwise")

    walls = {"plain": [], "retry": []}
    for _ in range(3):
        for kind in walls:
            j = build("set1", "float32")
            j = j.retry() if kind == "retry" else j
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            j.run()
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"fault-free cost of .retry() on set1 main float32 sync "
          f"({smi}): {med['plain']:.4f} s without, {med['retry']:.4f} "
          f"s with ({med['retry'] / med['plain'] - 1:+.2%}); walls "
          f"{json.dumps(walls)}; not gated")
    phase_done("9")

    # -- phase 10: the multi-tenant service over the card --------------------
    service_launches = phase10(
        api, np, torch, sets, wavs, counters, build, detect, all_equal,
        logs_equal, main_results, det_results, expected, det_expected,
        decoded, smi)
    wav_tmp.cleanup()
    phase_done("10")

    # -- phase 11: the LM serving path at full width -------------------------
    lm_launches = phase11(np, torch, sets, counters, smi)
    phase_done("11")

    p, m = sets["set1"][:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.job(m, p).run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"job set1 device synthesis, default entry point: "
          f"{res.n_records} records in {dt:.3f} s, "
          f"{res.n_records / dt:.2f} records/s, "
          f"{res.n_records * p.record_size_sec / dt:.1f} x realtime")
    check(res["welch"].shape == (m.n_records, p.n_bins)
          and bool(np.isfinite(res["welch"]).all())
          and bool(np.isfinite(res["tol"]).all()),
          "default entry point output")

    for r in report:
        r["launches"] = launches[r["name"]]
        r["sharded_launches"] = sharded_launches[r["name"]]
        r["service_launches"] = service_launches[r["name"]]
        r["lm_launches"] = lm_launches[r["name"]]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
