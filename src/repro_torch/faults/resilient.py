"""Resilience wrappers: retry at the IO seams, quarantine bad records.

Two families of wrappers, both plain :class:`~repro_torch.api.sources.Source`
/ :class:`~repro_torch.api.sinks.Sink` decorators (no monkeypatching, no
engine special cases):

  * :class:`FaultySource` / :class:`FaultySink` **inject** a
    :class:`~repro_torch.faults.plan.FaultPlan` at the read/write seams —
    test doubles that make the schedule observable to the production
    machinery below them;
  * :class:`ResilientSource` / :class:`ResilientSink` **survive**: a
    shared :class:`~repro_torch.faults.retry.Retrier` absorbs transient
    errors, and a :class:`Quarantine` (opt-in via
    ``SoundscapeJob.tolerate(bad_records=N)``) isolates bad records by
    bisection — Spark's ignore-corrupt-files semantics, but *accounted*:
    every quarantined record is named, budgeted, committed next to the
    cursor, and reported in ``JobResult.quarantine``.

Composition order (``SoundscapeJob`` applies it)::

    PrefetchSource(ResilientSource(FaultySource(inner)))   # reads
    AsyncSink(ResilientSink(FaultySink(inner)))            # writes

so prefetch read-tasks retry *inside* the loader's worker threads, and
the AsyncSink worker retries a flaky write before the error turns
sticky — "goes sticky only after the retry budget".
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.api.sinks import Sink
from repro_torch.api.sources import Source

from .errors import QuarantineExceeded, is_bad_record
from .plan import FaultPlan
from .retry import Retrier


class Quarantine:
    """The accounted bad-record set of one job.

    Thread-safe (prefetch read tasks quarantine concurrently).  The
    budget is TOTAL across the job's lifetime including resumed runs:
    the committed set rides the cursor (as the ``__quarantine__`` carry
    key), so a resumed job restores both the mask and the spent budget
    bitwise.
    """

    def __init__(self, budget: int):
        if budget < 0:
            raise ValueError(f"bad-record budget must be >= 0, got "
                             f"{budget}")
        self.budget = int(budget)
        self._lock = threading.Lock()
        self._records: dict[int, str] = {}

    def add(self, record: int, error: BaseException) -> None:
        """Quarantine one record; raises
        :class:`~repro_torch.faults.errors.QuarantineExceeded` (chaining the
        record's error) once the budget is spent."""
        with self._lock:
            if record in self._records:
                return
            if len(self._records) >= self.budget:
                raise QuarantineExceeded(
                    f"bad-record budget exhausted: record {record} "
                    f"(fault {getattr(error, 'fault', 'unknown')!r}: "
                    f"{error}) would be bad record "
                    f"#{len(self._records) + 1} but "
                    f".tolerate(bad_records={self.budget}) allows only "
                    f"{self.budget}; already quarantined: "
                    f"{sorted(self._records)}") from error
            self._records[record] = (
                f"{getattr(error, 'fault', type(error).__name__)}: "
                f"{error}")

    def seed(self, records: np.ndarray) -> None:
        """Restore a committed quarantine set on resume (reasons were
        reported by the run that quarantined them)."""
        with self._lock:
            for r in np.asarray(records).reshape(-1):
                self._records.setdefault(
                    int(r), "restored from committed cursor")

    def mask_for(self, indices: np.ndarray) -> np.ndarray:
        """Boolean mask of ``indices`` that are quarantined."""
        idx = np.asarray(indices)
        with self._lock:
            if not self._records:
                return np.zeros(idx.shape, bool)
            bad = np.fromiter(self._records, np.int64,
                              len(self._records))
        return np.isin(idx, bad)

    def as_array(self) -> np.ndarray:
        """Sorted committed-form snapshot (rides the commit carry)."""
        with self._lock:
            return np.asarray(sorted(self._records), np.int64)

    def report(self) -> dict:
        """The loud accounting for ``JobResult.quarantine`` /
        summary.json."""
        with self._lock:
            return {"budget": self.budget,
                    "records": sorted(self._records),
                    "reasons": {r: self._records[r]
                                for r in sorted(self._records)}}

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class _DelegatingSource(Source):
    """Shared plumbing: forward the full Source protocol to ``inner``.

    ``stream`` is NOT forwarded — it stays the base fetch-per-step
    implementation so every payload flows through this wrapper's
    ``fetch`` (injection/resilience included); a PrefetchSource wrapping
    *outside* drives the same ``fetch`` from its read pool.
    """

    def __init__(self, inner: Source):
        self.inner = inner

    @property
    def payload_dtype(self) -> str:
        return self.inner.payload_dtype

    def bind(self, m, p):
        self.inner = self.inner.bind(m, p)
        return self

    def with_payload(self, dtype):
        self.inner = self.inner.with_payload(dtype)
        return self

    def fetch(self, indices):
        return self.inner.fetch(indices)

    def scales(self, indices):
        return self.inner.scales(indices)

    def close(self):
        self.inner.close()


class FaultySource(_DelegatingSource):
    """Inject a FaultPlan's read faults ahead of any host-fed source."""

    def __init__(self, inner: Source, plan: FaultPlan):
        if inner.device_synth:
            raise ValueError(
                "FaultySource wraps host-fed sources; device-synthesized "
                "records never take the host read path")
        super().__init__(inner)
        self.plan = plan

    def fetch(self, indices):
        self.plan.check_read(indices)
        return self.inner.fetch(indices)


class ResilientSource(_DelegatingSource):
    """Retry transient read errors; bisect + quarantine bad records.

    A batched fetch that trips a bad-record error is split in half and
    refetched (reads are pure, so refetching good halves is safe); a
    single failing record is quarantined — zero payload, masked out of
    every reduction by the engine — under the job's budget.  Records
    already quarantined are zeroed up front, so a resumed job never
    re-bisects its committed bad set.
    """

    def __init__(self, inner: Source, retrier: Retrier | None = None,
                 quarantine: Quarantine | None = None):
        super().__init__(inner)
        self.retrier = retrier
        self.quarantine = quarantine

    def _attempt(self, flat: np.ndarray) -> np.ndarray:
        if self.retrier is None:
            return self.inner.fetch(flat)
        return self.retrier.call(self.inner.fetch, flat)

    def _fetch_flat(self, flat: np.ndarray) -> np.ndarray:
        try:
            return self._attempt(flat)
        except BaseException as e:       # noqa: BLE001
            if self.quarantine is None or not is_bad_record(e):
                raise
            if flat.size == 1:
                # isolated: quarantine (budget-checked) and mask
                self.quarantine.add(int(flat[0]), e)
                one = self.inner.fetch(np.full(1, -1, flat.dtype))
                return np.zeros_like(one)
            mid = flat.size // 2
            return np.concatenate([self._fetch_flat(flat[:mid]),
                                   self._fetch_flat(flat[mid:])], axis=0)

    def fetch(self, indices):
        idx = np.asarray(indices)
        flat = idx.reshape(-1)
        if self.quarantine is not None and len(self.quarantine):
            known = self.quarantine.mask_for(flat)
            if known.any():
                # fetch only the still-good records; quarantined slots
                # read as padding (index -1 -> zeros) so no bad read
                # re-fires on resume
                safe = np.where(known, -1, flat)
                out = self._fetch_flat(safe)
                return out.reshape(idx.shape + out.shape[1:])
        out = self._fetch_flat(flat)
        return out.reshape(idx.shape + out.shape[1:])


class _DelegatingSink(Sink):
    """Forward the full Sink protocol to ``inner``."""

    def __init__(self, inner: Sink):
        self.inner = inner
        self.resumable = inner.resumable
        self.wants_commit = inner.wants_commit

    def open(self, m, p, shapes, plan):
        self.inner.open(m, p, shapes, plan)

    def open_windows(self, shapes):
        self.inner.open_windows(shapes)

    def open_events(self, layouts):
        self.inner.open_events(layouts)

    def resume_state(self):
        return self.inner.resume_state()

    def committed_steps(self, plan):
        return self.inner.committed_steps(plan)

    def committed_plan(self):
        return self.inner.committed_plan()

    def write(self, step, indices, values):
        self.inner.write(step, indices, values)

    def write_windows(self, name, start, values):
        self.inner.write_windows(name, start, values)

    def write_events(self, step, indices, values):
        self.inner.write_events(step, indices, values)

    def commit(self, plan, step, agg, live):
        self.inner.commit(plan, step, agg, live)

    def result(self):
        return self.inner.result()

    def event_result(self):
        return self.inner.event_result()

    def close(self):
        self.inner.close()


class FaultySink(_DelegatingSink):
    """Inject a FaultPlan's sink faults ahead of any sink."""

    def __init__(self, inner: Sink, plan: FaultPlan):
        super().__init__(inner)
        self.plan = plan

    def write(self, step, indices, values):
        self.plan.check_sink("sink.write", step)
        self.inner.write(step, indices, values)

    def commit(self, plan, step, agg, live):
        self.plan.check_sink("sink.commit", step)
        self.inner.commit(plan, step, agg, live)


class ResilientSink(_DelegatingSink):
    """Retry transient write/commit errors under the shared budget.

    Writes are idempotent (per-record overwrites / cursor-guarded
    appends ride *behind* the write in the commit order), so re-running
    a failed write is safe.  Inside an :class:`~repro_torch.api.sinks.
    AsyncSink` this runs on the worker thread: the worker's error only
    turns sticky after the budget here is spent.

    ``write_events`` is NOT retried: an event append that failed midway
    may have committed partial rows to the open log file, and blindly
    re-appending would duplicate them.  Event-log durability is instead
    the store's crash contract (truncate-to-committed on resume), which
    a loud failure here hands over to.
    """

    def __init__(self, inner: Sink, retrier: Retrier):
        super().__init__(inner)
        self.retrier = retrier

    def write(self, step, indices, values):
        self.retrier.call(self.inner.write, step, indices, values)

    def write_windows(self, name, start, values):
        self.retrier.call(self.inner.write_windows, name, start, values)

    def commit(self, plan, step, agg, live):
        self.retrier.call(self.inner.commit, plan, step, agg, live)
