"""Live detection: seeded records, half of them with pile-driving strikes,
pushed open loop into the program's ``serve.LiveSource`` ring; the job
computes the Welch PSD, the spectrum percentiles, the SPD over windows
of ``window_records`` records, the loud events and their impulsive
metrics, and streams each step's features, each window as it closes and
each step's events to a callback.

The configuration gives the parameters, the detection thresholds, the
strikes and the pool of distinct records (``distinct_records``); the mix
the arrivals (``harness/arrivals.py``), the ring, the features, the
window, the records a step (``chunk``), the steps in flight, the
prefetch depth and the payload.  The window drives exactly the steps
that the window's arrivals fill, and gives up at ``give_up_x`` times its
length (2): it stops stepping and pushing, finishes the job, and counts
what never arrived as failed, so that no program can keep a run going
however far behind it falls.

  * ``record_p95_ms``: the 95th percentile, over every record of the
    window, of the time from its due push to its per-record features
    reaching the sink;
  * ``failed``: the window's records that the sink did not receive
    exactly once, and the windows holding any of them that the sink did
    not receive exactly once;
  * the check, on a sample drawn from the seed: for 48 records, the
    Welch PSD, the percentiles, the events and their impulsive metrics
    the sink received against the reference's
    (``reference/detect_ref.py``) from the same pushed PCM and decode
    scale, the events held to the reference's frame levels
    (``harness/detect_check.py``); for 2 windows closed inside the
    measured window, the SPD against the reference's over the window's
    records; and the epoch mean Welch PSD the job publishes against the
    mean of every row the sink received.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from harness import (arrivals, check, detect_check, instruments, strikes,
                     trace)
from reference import depam_ref as R
from reference import detect_ref as D


def build(ctx) -> "LiveDetect":
    return LiveDetect(ctx)


class Received:
    """What the sink received: every record's Welch PSD, the kept
    records' percentiles and events, the kept windows' SPD, how many
    times each record and each window was delivered, and when each
    record's features arrived."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self.keep_records: set = set()
        self.keep_windows: set = set()
        self.welch: dict[int, np.ndarray] = {}
        self.pct: dict[int, np.ndarray] = {}
        self.events: dict[int, dict] = {}
        self.spd: dict[int, np.ndarray] = {}
        self.times: dict[int, int] = {}
        self.arrived: dict[int, float] = {}
        self.flushed: dict[int, int] = {}

    def on_values(self, step, indices, values):
        t = time.perf_counter()
        for i, w, pc in zip(indices.tolist(), values["welch"],
                            values["percentiles"]):
            self.welch[i] = w
            if i in self.keep_records:
                self.pct[i] = pc
        with self._lock:
            for i in indices.tolist():
                self.times[i] = self.times.get(i, 0) + 1
                self.arrived[i] = t

    def on_windows(self, name, start, values):
        if name != "spd":
            return
        for w in range(start, start + len(values)):
            self.flushed[w] = self.flushed.get(w, 0) + 1
            if w in self.keep_windows:
                self.spd[w] = np.array(values[w - start])

    def on_events(self, step, indices, values):
        for name, (counts, rows) in values.items():
            offs = np.concatenate(
                [[0], np.cumsum(np.minimum(counts, self.capacity))])
            for j, i in enumerate(indices.tolist()):
                if i in self.keep_records:
                    self.events.setdefault(i, {})[name] = \
                        np.array(rows[offs[j]:offs[j + 1]])

    def delivered(self) -> int:
        with self._lock:
            return len(self.arrived)


class LiveDetect:
    def __init__(self, ctx):
        from repro_torch import api
        from repro_torch.core.manifest import DatasetManifest
        from repro_torch.serve import LiveSource

        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        mix, p = ctx.mix, ctx.p
        self.chunk = int(mix["chunk"])
        self.window_records = int(mix["window_records"])
        self.pool, self.scales, self.struck = strikes.strike_pool(
            ctx.cfg, ctx.seed, int(ctx.cfg["distinct_records"]), ctx.device)
        self.live = LiveSource(p.record_size, capacity=mix["ring_capacity"],
                               payload_dtype=mix["payload"])
        self.got = Received(p.event_capacity)
        sink = api.CallbackSink(self.got.on_values,
                                on_windows=self.got.on_windows,
                                on_events=self.got.on_events)
        if mix["inflight"] > 0:
            sink = instruments.spanned_async_sink(ctx.spans)(sink)
        rpf = int(round(ctx.cfg["file_sec"] / ctx.cfg["record_size_sec"]))
        m = DatasetManifest(n_files=int(ctx.cfg["n_files"]),
                            records_per_file=rpf, record_size=p.record_size,
                            fs=p.fs)
        feats = [f for f in mix["features"]
                 if f not in ("events", "impulsive")]
        self.stepper = (
            api.job(m, p).features(*feats)
            .events(impulsive="impulsive" in mix["features"])
            .window(records=self.window_records).source(self.live)
            .to(sink).chunk(self.chunk)
            .async_io(depth=mix["prefetch_depth"], inflight=mix["inflight"])
            .payload(mix["payload"]).device(ctx.device))._stepper()
        self.pushed = 0
        self.first = self.n = 0
        self.mean = None
        self._stop = False

    def push(self, _k: int = 0) -> None:
        if self._stop:
            return
        k = self.pushed % len(self.pool)
        try:
            self.live.push(self.pool[k], self.scales[k])
        except RuntimeError:
            if not self._stop:      # the window gave up and ended the ring
                raise
            return
        self.pushed += 1

    def warm(self, steps: int) -> None:
        for _ in range(steps):
            for _ in range(self.chunk):
                self.push()
            self.stepper.step_once()

    def _windows_inside(self) -> range:
        """The windows that hold records of the measured window."""
        w = self.window_records
        return range(self.first // w, (self.first + self.n - 1) // w + 1)

    def window(self, t0: float, seconds: float) -> dict:
        due = arrivals.schedule(self.mix["arrivals"], seconds)
        self.n = len(due) // self.chunk * self.chunk
        due = due[:self.n]
        self.first = first = self.pushed
        rng = np.random.default_rng([int(self.ctx.seed), 7])
        got = self.got
        got.keep_records = set(check.sample(
            rng, first, first + self.n,
            self.mix["check"]["records"]).tolist())
        w = self.window_records
        closed = np.arange(-(-first // w), (first + self.n) // w)
        got.keep_windows = set(rng.choice(
            closed, size=min(self.mix["check"]["windows"], len(closed)),
            replace=False).tolist())
        pusher = arrivals.Pusher(self.push, due, t0,
                                 lambda: got.delivered() - first)
        deadline = t0 + float(self.mix["give_up_x"]) * seconds
        steps = 0
        pusher.start()
        try:
            with self.ctx.spans.span(trace.WINDOW_SPAN):
                for _ in range(self.n // self.chunk):
                    if time.perf_counter() > deadline:
                        break
                    self.stepper.step_once()
                    steps += 1
        finally:
            self._stop = True
            self.live.end()
            pusher.join()
        self.mean = self.stepper.finish()[1]["mean_welch"]
        lat = np.array([got.arrived.get(first + k, math.inf) - t0 - due[k]
                        for k in range(self.n)])
        failed = sum(got.times.get(first + k, 0) != 1 for k in range(self.n))
        failed += sum(got.flushed.get(v, 0) != 1
                      for v in self._windows_inside())
        t_end = max(got.arrived.values()) if got.arrived else t0
        return {"steps": steps, "seconds": t_end - t0,
                "attempted": self.n + len(self._windows_inside()),
                "failed": int(failed),
                "metrics": {"record_p95_ms":
                            float(np.quantile(lat, 0.95)) * 1e3},
                "extra": {"latency_s": lat, "late_s": pusher.late,
                          "backlog": pusher.backlog}}

    # -- the check ---------------------------------------------------------

    def _x(self, i: int, precision: str) -> torch.Tensor:
        k = int(i) % len(self.pool)
        return R.decode(self.pool[k], self.scales[k], self.ctx.device,
                        precision)

    def check(self, control: bool) -> dict[str, float]:
        """The cell's numbers on the sample.  ``control=True`` puts the
        control in the program's place: the reference in TF32 (the DFT
        and the sums over an event's samples), and the reductions (the
        SPD's window histogram, the epoch mean) kept in bfloat16, on the
        same sample."""
        rp = check.params(self.cfg)
        p = self.ctx.p
        got = self.got
        numbers = dict.fromkeys(detect_check.NUMBERS, 0.0)
        for i in sorted(got.keep_records):
            if control:
                cand = self._record(i, rp, p, "tf32")
            else:
                # a record the sink never received reads as NaN, and fails
                ev = got.events.get(i, {})
                cand = {"welch": got.welch.get(i, np.nan),
                        "pct": got.pct.get(i, np.nan),
                        "events": ev.get("events", np.zeros((0, 4))),
                        "impulsive": ev.get("impulsive", np.zeros((0, 4)))}
            ref = self._record(i, rp, p, "f64", cand["events"])
            one = detect_check.record_numbers(
                cand, ref, p.event_threshold_db, p.event_hysteresis_db,
                p.event_min_len)
            for k, v in one.items():
                if not (math.isnan(numbers[k]) or v <= numbers[k]):
                    numbers[k] = v      # the larger, or NaN
        numbers["spd_share"] = float(np.max(
            [self._spd_share(w, rp, control) for w in got.keep_windows]
            or [0.0]))
        rows = np.stack([got.welch[i] for i in sorted(got.welch)])
        mean = check.bf16_mean(rows, self.chunk, self.ctx.device) \
            if control else self.mean
        numbers["mean_rel"] = check.mean_rel(mean, rows)
        return numbers

    def _record(self, i, rp, p, precision, spans=None) -> dict:
        """One record through the reference in ``precision``: its Welch
        PSD, percentiles, frame levels and dB spectrogram, events, and
        the impulsive metrics over ``spans``' events (its own where
        None)."""
        x = self._x(i, precision)
        psd, fdb = D.frame_db(x, rp, precision)
        spl = D.frame_spl(psd, rp).double().cpu().numpy()
        peak = torch.argmax(psd, dim=-1).cpu().numpy()
        ev = D.events(spl, peak, p.event_threshold_db,
                      p.event_hysteresis_db, p.event_min_len)
        rows = ev if spans is None else detect_check.event_rows(spans)
        return {"welch": psd.mean(dim=0).double().cpu().numpy(),
                "pct": D.percentiles(fdb).double().cpu().numpy(),
                "spl": spl, "fdb": fdb.double().cpu().numpy(),
                "events": ev,
                "impulsive": D.impulsive(x, rows, rp, precision)}

    def _spd_share(self, w: int, rp, control: bool) -> float:
        """The share of a window's frames that the candidate puts in
        another dB bin than the reference does, averaged over frequency
        bins: half the L1 distance of the two densities over dB."""
        recs = range(w * self.window_records, (w + 1) * self.window_records)
        counts = {}
        for prec in ("f64",) + (("tf32",) if control else ()):
            per = [D.spd_counts(D.frame_db(self._x(i, prec), rp, prec)[1])
                   for i in recs]
            counts[prec] = D.bf16_window(per, self.chunk) \
                if prec == "tf32" else torch.stack(per).sum(dim=0)
        ref = D.spd_density(counts["f64"])
        if not control and w not in self.got.spd:
            return math.nan
        cand = D.spd_density(counts["tf32"]) if control else torch.as_tensor(
            self.got.spd[w], dtype=torch.float64, device=ref.device)
        share = (cand - ref).abs().sum(dim=-1) * D.SPD_DB_STEP / 2
        return float(share.mean())

