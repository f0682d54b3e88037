"""Deterministic, seedable fault injection — the chaos schedule.

Spark survives failures because failures are *routine*; the only way to
trust our retry/quarantine/restart machinery equally is to exercise it
on demand, deterministically, at the exact seams the machinery guards.
A :class:`FaultPlan` is that schedule: a tuple of :class:`FaultSpec`\\ s,
each naming a fault kind, the seam (*site*) it fires at, what it
matches (a global record index for read faults, a step for sink
faults, nothing for crash points), and how many times it fires.

Determinism contract — the reason a schedule replays bitwise:

  * read faults match by **global record index**, never by invocation
    count.  Concurrent prefetch tasks, speculative duplicate reads, and
    resume-time refetches all consult the same per-record rule, so the
    set of failing reads is a pure function of the data layout — the
    same lineage property that makes speculative reads safe makes
    injected read faults replayable;
  * per-spec fire budgets (``times``) are counted under a lock, so "the
    first two attempts fail, the third succeeds" is exact even when
    attempts race (which attempt succeeds is unordered, but reads are
    pure, so the payload is identical either way);
  * :meth:`FaultPlan.scheduled` derives a whole schedule from one RNG
    seed — the fixed-seed matrix ``scripts/torch_chaos_smoke.py`` replays.

Injection happens through explicit wrappers and hooks
(:class:`~repro_torch.faults.resilient.FaultySource`,
:class:`~repro_torch.faults.resilient.FaultySink`,
``FeatureStore(faults=...)``) — never monkeypatching — so the no-hooks
production path contains no injection code at all, and a plan threaded
through ``SoundscapeJob.inject()`` reaches every seam of that one job
without touching global state.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from .errors import (CorruptRecordError, InjectedCrash, SinkWriteError,
                     StreamStall, TransientReadError, TruncatedRecordError)

#: fault kinds a FaultSpec may name, and the seam each fires at.
KINDS = {
    "read_transient": "source.fetch",     # retryable read error
    "record_corrupt": "source.fetch",     # quarantinable, deterministic
    "record_truncated": "source.fetch",   # quarantinable, deterministic
    "slow_read": "source.fetch",          # straggler (sleeps, no error)
    "live_stall": "source.fetch",         # StreamStall (park + restart)
    "sink_write": "sink.write",           # retryable write error
    "sink_commit": "sink.commit",         # retryable commit error
    "crash_after_sidecar": "store.commit",   # die between sidecar and
    "crash_before_commit": "store.commit",   # cursor rename / before it
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One named failure rule.

    ``record`` matches read faults (global record index), ``step``
    matches sink faults, neither matches store crash points (they fire
    on the site's n-th visit instead, ``after_visits``).  ``times``
    bounds how often the rule fires (None = every match — the shape of
    a deterministically corrupt record); ``delay_s`` is the injected
    straggler latency for ``slow_read``.
    """

    kind: str
    record: int | None = None
    step: int | None = None
    times: int | None = 1
    delay_s: float = 0.0
    after_visits: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick one of "
                f"{sorted(KINDS)}")

    @property
    def site(self) -> str:
        return KINDS[self.kind]


class FaultPlan:
    """A deterministic schedule of :class:`FaultSpec` firings.

    Thread-safe; per-spec fire counts (and per-site visit counts for
    crash points) live on the plan, so one plan instance threads
    through every seam of one job.  ``stats()`` reports what actually
    fired — the chaos tests assert schedules were exercised, not just
    survived by accident.
    """

    def __init__(self, specs: tuple[FaultSpec, ...] | list[FaultSpec] = ()):
        self.specs = tuple(specs)
        self._fired = [0] * len(self.specs)
        self._visits: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- schedule construction ------------------------------------------
    @classmethod
    def scheduled(cls, seed: int, n_records: int, n_steps: int, *,
                  transient_reads: int = 2, corrupt_records: int = 0,
                  truncated_records: int = 0, sink_writes: int = 0,
                  crashes: int = 0, stalls: int = 0,
                  slow_reads: int = 0, slow_s: float = 0.05,
                  transient_times: int = 2) -> "FaultPlan":
        """Derive a whole schedule from one RNG seed — the fixed-seed
        chaos matrix.  Record/step targets are drawn without
        replacement where possible, so the same seed always yields the
        same schedule."""
        rng = np.random.default_rng(seed)

        def draw(n, hi):
            if hi <= 0 or n <= 0:
                return []
            return [int(v) for v in
                    rng.choice(hi, size=min(n, hi), replace=False)]

        specs: list[FaultSpec] = []
        specs += [FaultSpec("read_transient", record=r,
                            times=transient_times)
                  for r in draw(transient_reads, n_records)]
        specs += [FaultSpec("record_corrupt", record=r, times=None)
                  for r in draw(corrupt_records, n_records)]
        specs += [FaultSpec("record_truncated", record=r, times=None)
                  for r in draw(truncated_records, n_records)]
        specs += [FaultSpec("slow_read", record=r, times=1,
                            delay_s=slow_s)
                  for r in draw(slow_reads, n_records)]
        specs += [FaultSpec("live_stall", record=r, times=1)
                  for r in draw(stalls, n_records)]
        specs += [FaultSpec("sink_write", step=s, times=1)
                  for s in draw(sink_writes, n_steps)]
        for i in range(crashes):
            kind = ("crash_after_sidecar" if i % 2 == 0
                    else "crash_before_commit")
            specs.append(FaultSpec(kind, times=1,
                                   after_visits=int(rng.integers(
                                       0, max(1, n_steps)))))
        return cls(specs)

    # -- matching -------------------------------------------------------
    def _take(self, i: int) -> bool:
        """Consume one firing of spec ``i`` if budget remains."""
        spec = self.specs[i]
        with self._lock:
            if spec.times is not None and self._fired[i] >= spec.times:
                return False
            self._fired[i] += 1
            return True

    def check_read(self, records: np.ndarray) -> None:
        """Source-read seam: raise/delay per the schedule for a batch of
        global record indices.  The LOWEST matching record of the batch
        fires first, so bisection isolates records deterministically."""
        flat = np.asarray(records).reshape(-1)
        hits: list[tuple[int, int]] = []          # (record, spec index)
        for i, spec in enumerate(self.specs):
            if spec.site != "source.fetch" or spec.record is None:
                continue
            if spec.times is not None and self._fired[i] >= spec.times:
                continue                           # racy fast-path only
            if (flat == spec.record).any():
                hits.append((spec.record, i))
        for record, i in sorted(hits):
            spec = self.specs[i]
            if not self._take(i):
                continue
            if spec.kind == "slow_read":
                time.sleep(spec.delay_s)
                continue
            if spec.kind == "read_transient":
                raise TransientReadError(
                    f"injected transient read error (fault "
                    f"'read_transient') at record {record}",
                    record=record)
            if spec.kind == "record_corrupt":
                raise CorruptRecordError(
                    f"injected corrupt record (fault 'record_corrupt') "
                    f"at record {record}: payload bytes fail decode",
                    record=record)
            if spec.kind == "record_truncated":
                raise TruncatedRecordError(
                    f"injected truncated record (fault "
                    f"'record_truncated') at record {record}: file "
                    f"shorter than the manifest says", record=record)
            if spec.kind == "live_stall":
                raise StreamStall(
                    f"injected live-source stall (fault 'live_stall') "
                    f"at record {record}: producer starved the fetch")

    def check_sink(self, site: str, step: int) -> None:
        """Sink seam (``sink.write`` / ``sink.commit``): raise per the
        schedule for one step."""
        for i, spec in enumerate(self.specs):
            if spec.site != site or spec.step != step:
                continue
            if self._take(i):
                raise SinkWriteError(
                    f"injected sink error (fault {spec.kind!r}) at "
                    f"step {step}")

    def crash(self, kind: str) -> None:
        """Store crash point: raise :class:`InjectedCrash` when the
        schedule says this visit of ``kind`` dies."""
        with self._lock:
            visit = self._visits.get(kind, 0)
            self._visits[kind] = visit + 1
        for i, spec in enumerate(self.specs):
            if spec.kind != kind or visit < spec.after_visits:
                continue
            if self._take(i):
                raise InjectedCrash(kind, fault=kind)

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            fired = list(self._fired)
        return {"specs": len(self.specs),
                "fired": sum(1 for f in fired if f),
                "firings": sum(fired),
                "by_kind": {
                    k: sum(f for s, f in zip(self.specs, fired)
                           if s.kind == k)
                    for k in sorted({s.kind for s in self.specs})}}

    def __repr__(self):
        return f"FaultPlan({len(self.specs)} specs, {self.stats()})"
