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

Launch counters, set to 0 before each path and read after it, show
which kernels each path went through.  Any failed check raises, so the
script exits non-zero and never prints the ``ok`` line.

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
    from torch.autograd import DeviceType
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
    evs = list(prof.events())
    on_dev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in evs if e.device_type == DeviceType.CUDA)
    if on_dev:
        busy, end = 0.0, -math.inf
        for a, b, _ in on_dev:
            if b > end:
                busy += b - max(a, end)
                end = b
        span = (max(e.time_range.end for e in evs)
                - min(e.time_range.start for e in evs))
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
    wav_tmp.cleanup()
    phase_done("9")

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
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
