"""A live feed: seeded records pushed open loop into the program's
``serve.LiveSource`` ring, the job's features streamed to a callback.

The configuration gives the parameters and the pool of distinct records
(``distinct_records``); the mix the arrivals (``harness/arrivals.py``),
the ring, the features, the records a step (``chunk``), the steps in
flight, the prefetch depth and the payload.
The window drives exactly the steps that the window's arrivals fill.

  * ``record_p95_ms``: the 95th percentile, over every record of the
    window, of the time from its due push to its features reaching the
    sink;
  * ``failed``: the window's records that the sink did not receive
    exactly once -- the live feed's guarantee;
  * the check: a sample of the window's records, drawn from the seed,
    the features the sink received against the reference's from the
    same pushed PCM and decode scale; and the epoch mean the job
    publishes against the mean of every row the sink received.
"""
from __future__ import annotations

import math

import numpy as np

from harness import arrivals, check, data, instruments, trace
from reference import depam_ref as R


def build(ctx) -> "Live":
    return Live(ctx)


class Live:
    def __init__(self, ctx):
        from repro_torch import api
        from repro_torch.core.manifest import DatasetManifest
        from repro_torch.serve import LiveSource

        self.ctx, self.cfg, self.mix = ctx, ctx.cfg, ctx.mix
        mix, p = ctx.mix, ctx.p
        self.chunk = int(mix["chunk"])
        self.pool, self.scales = data.live_pool(
            ctx.cfg, ctx.seed, int(ctx.cfg["distinct_records"]),
            ctx.device)
        self.live = LiveSource(p.record_size, capacity=mix["ring_capacity"],
                               payload_dtype=mix["payload"])
        self.delivery = instruments.Delivery()
        sink = self.delivery.sink()
        if mix["inflight"] > 0:
            sink = instruments.spanned_async_sink(ctx.spans)(sink)
        rpf = int(round(ctx.cfg["file_sec"] / ctx.cfg["record_size_sec"]))
        m = DatasetManifest(n_files=int(ctx.cfg["n_files"]),
                            records_per_file=rpf, record_size=p.record_size,
                            fs=p.fs)
        self.stepper = (
            api.job(m, p).features(*mix["features"]).source(self.live)
            .to(sink).chunk(self.chunk)
            .async_io(depth=mix["prefetch_depth"], inflight=mix["inflight"])
            .payload(mix["payload"]).device(ctx.device))._stepper()
        self.pushed = 0
        self.first = self.n = 0
        self.result = None

    def push(self, _k: int = 0) -> None:
        k = self.pushed % len(self.pool)
        self.live.push(self.pool[k], self.scales[k])
        self.pushed += 1

    def warm(self, steps: int) -> None:
        for _ in range(steps):
            for _ in range(self.chunk):
                self.push()
            self.stepper.step_once()

    def window(self, t0: float, seconds: float) -> dict:
        due = arrivals.schedule(self.mix["arrivals"], seconds)
        self.n = len(due) // self.chunk * self.chunk
        due = due[:self.n]
        self.first = first = self.pushed
        pusher = arrivals.Pusher(self.push, due, t0,
                                 lambda: self.delivery.delivered() - first)
        spans = self.ctx.spans
        pusher.start()
        try:
            with spans.span(trace.WINDOW_SPAN):
                for _ in range(self.n // self.chunk):
                    self.stepper.step_once()
        finally:
            pusher.join()
        self.result = self.stepper.finish()
        d = self.delivery
        lat = np.array([d.arrived.get(first + k, math.inf) - t0 - due[k]
                        for k in range(self.n)])
        failed = sum(d.times.get(first + k, 0) != 1 for k in range(self.n))
        t_end = max(d.arrived.values()) if d.arrived else t0
        return {"steps": self.n // self.chunk, "seconds": t_end - t0,
                "attempted": self.n, "failed": int(failed),
                "metrics": {"record_p95_ms":
                            float(np.quantile(lat, 0.95)) * 1e3},
                "extra": {"latency_s": lat, "late_s": pusher.late,
                          "backlog": pusher.backlog}}

    def check(self, control: bool) -> dict[str, float]:
        """The cell's numbers on a sample of the window's records.
        ``control=True`` puts the control in the program's place: the
        reference in TF32 (the DFT and the band sums), and the reduction
        stage kept in bfloat16, on the same sample."""
        rp = check.params(self.cfg)
        dev = self.ctx.device
        rng = np.random.default_rng([int(self.ctx.seed), 7])
        idx = check.sample(rng, self.first, self.first + self.n,
                           self.mix["check"]["records"])

        def x_of(i, precision):
            k = int(i) % len(self.pool)
            return R.decode(self.pool[k], self.scales[k], dev, precision)

        ref = _stack([check.reference_features(x_of(i, "f64"), rp, "f64")
                      for i in idx])
        got = self.delivery.values
        rows = np.stack([got["welch"][i] for i in sorted(got["welch"])])
        if control:
            cand = _stack([check.reference_features(x_of(i, "tf32"), rp,
                                                    "tf32") for i in idx])
            mean = check.bf16_mean(rows, self.chunk, dev)
        else:
            cand = {name: np.stack([got[name][i] for i in idx])
                    for name in ("welch", "spl", "tol")}
            mean = self.result[1]["mean_welch"]
        numbers = check.feature_numbers(cand, ref)
        numbers["mean_rel"] = check.mean_rel(mean, rows)
        return numbers


def _stack(rows: list[dict]) -> dict:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
