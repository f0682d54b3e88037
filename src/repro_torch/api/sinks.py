"""Result sinks — where features go.

The engine hands every sink:

  * ``open(manifest, params, shapes, plan)`` — the per-record layout,
    ``{feature: per_record_shape}``, before the first step;
  * ``write(step, indices, values)`` — the live records of one step;
  * ``commit(plan, step, agg, live)`` — after each step, the reduction
    carry (``__r:<window>:<out>:<field>`` keys, ``:c`` Kahan companions)
    as host numpy arrays in their native dtypes; sinks persist the
    mapping opaquely, which is what makes resume bitwise-exact;
  * ``open_windows`` / ``write_windows`` — the windowed outputs'
    layout and their finalized rows (closed windows at commit
    boundaries, the trailing ones at job end);
  * ``open_events`` / ``write_events`` — the ragged (event) outputs'
    ``{feature: (columns, capacity)}`` layouts and each step's
    host-compacted slice: per-record TRUE counts plus the kept rows,
    append-only in record order; ``event_result`` materializes them as
    :class:`EventLog` values.

Contract: ``open`` first, ``write(step=k)`` before ``commit(step=k)``,
steps ascending, and a commit makes every prior write durable — event
rows included: the resumable store keeps its own per-log row cursor, so
a crash between write and commit never duplicates or tears an event.
Every array the engine hands a sink is the sink's own: nothing else
writes to it afterwards, so a sink may keep it or queue it.
:class:`AsyncSink` moves any sink's IO onto a background writer with
the same ordering.
``as_sink`` normalizes what users pass to ``job.to()``: ``None`` ->
in-memory arrays, a path string or ``FeatureStore`` -> the resumable
store, a callable -> streaming callback, a ``Sink`` -> itself.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable

import numpy as np

from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore


@dataclasses.dataclass
class EventLog:
    """A materialized ragged event log (``JobResult.events`` values).

    ``counts[i]`` is the TRUE number of events detected in record ``i``
    (``counts[i] > capacity`` flags overflow: the first ``capacity``
    rows were kept, the rest dropped loudly).  ``rows`` concatenates the
    kept rows of every record in record order; use :meth:`record` /
    :attr:`offsets` to slice per record.
    """

    counts: np.ndarray            # (n_records,) int32, TRUE counts
    rows: np.ndarray              # (n_kept_total, len(columns)) float32
    columns: tuple[str, ...]
    capacity: int

    @property
    def kept(self) -> np.ndarray:
        """(n_records,) rows actually stored: min(counts, capacity)."""
        return np.minimum(self.counts, self.capacity)

    @property
    def offsets(self) -> np.ndarray:
        """(n_records + 1,) row offsets: record i owns
        rows[offsets[i]:offsets[i+1]]."""
        return np.concatenate([[0], np.cumsum(self.kept)]).astype(np.int64)

    @property
    def overflow(self) -> np.ndarray:
        """(n_records,) bool — records whose events exceeded capacity."""
        return self.counts > self.capacity

    @property
    def n_events(self) -> int:
        return int(self.kept.sum())

    def record(self, i: int) -> np.ndarray:
        o = self.offsets
        return self.rows[o[i]:o[i + 1]]

    def column(self, name: str) -> np.ndarray:
        return self.rows[:, self.columns.index(name)]


def reorder_event_rows(counts: np.ndarray, rows: np.ndarray,
                       capacity: int, order: np.ndarray) -> np.ndarray:
    """Permute an append-ordered event log into record order.

    A partitioned plan's shards advance in parallel, so the append-only
    log interleaves the spans (step-major); ``order`` is the plan's
    :meth:`record_order` — the global record ids in append order.  The
    permutation is pure bookkeeping: ``counts`` are per-record already,
    and each record's kept rows are contiguous within its append slot.
    Identity orders (every single-shard plan) return ``rows`` as-is, as
    does a partially-committed log whose appended total does not match
    the counts (only a completed log has a well-defined global order).
    """
    order = np.asarray(order, np.int64)
    if order.size == 0 or bool(np.all(np.diff(order) > 0)):
        return rows
    kept = np.minimum(np.asarray(counts), capacity).astype(np.int64)
    kept_append = kept[order]
    total = int(kept_append.sum())
    if total != len(rows):
        return rows
    src_start = np.concatenate([[0], np.cumsum(kept_append)[:-1]])
    dst_all = np.concatenate([[0], np.cumsum(kept)[:-1]])
    dst_start = dst_all[order]
    dst_idx = np.repeat(dst_start, kept_append) \
        + (np.arange(total) - np.repeat(src_start, kept_append))
    out = np.empty_like(rows)
    out[dst_idx] = rows
    return out


class Sink:
    resumable: bool = False
    # Whether commit() needs the reduction carry.  The engine keeps the
    # carry on the device and copies it to the host only at the commit
    # boundaries of sinks that want it.
    wants_commit: bool = True

    def open(self, m: DatasetManifest, p: DepamParams,
             shapes: dict[str, tuple[int, ...]], plan: ShardPlan) -> None:
        pass

    def set_instrument(self, instrument) -> None:
        """Calibration provenance (:class:`repro_torch.meta.Instrument`
        or None), delivered by the engine BEFORE ``open``.  Resumable
        sinks commit it with the cursor and refuse to resume under a
        changed calibration; labeled sinks additionally stamp it on
        output attrs.  Default: ignore."""

    def open_window_edges(self, edges: dict[str, np.ndarray]) -> None:
        """Per-output window edges ``{output: (n_windows + 1,) record
        offsets}``, delivered right after ``open_windows`` — the raw
        material labeled sinks turn into window time coordinates via
        ``manifest.record_times``.  Default: ignore."""

    def describe(self) -> dict:
        """Small JSON-safe description of where this sink's output
        lives (path, committed high-watermark...), surfaced by the
        serving layer's ``stats()``.  Default: empty."""
        return {}

    def resume_state(self):
        """(start_step, (agg, live) | None) — only resumable sinks skip."""
        return 0, None

    def committed_steps(self, plan: ShardPlan) -> int:
        """Steps of ``plan`` already durably committed."""
        return 0

    def committed_plan(self) -> dict | None:
        """The plan geometry of the committed cursor, or None."""
        return None

    def write(self, step: int, indices: np.ndarray,
              values: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def open_windows(self, shapes: dict[str, tuple[int, ...]]) -> None:
        """Windowed-output layout, ``{output: (n_windows, *shape)}``."""

    def write_windows(self, name: str, start: int,
                      values: np.ndarray) -> None:
        """Finalized window rows ``[start, start + len(values))``."""

    def open_events(self, layouts: dict[str, tuple[tuple[str, ...],
                                                   int]]) -> None:
        """Ragged-output layout, ``{feature: (columns, capacity)}``,
        right after ``open`` when the job selects ragged features."""

    def write_events(self, step: int, indices: np.ndarray,
                     values: dict[str, tuple[np.ndarray,
                                             np.ndarray]]) -> None:
        """One step's event-log slice: ``values`` maps feature name to
        ``(counts, rows)``, ``counts`` aligned with ``indices`` (TRUE
        per-record counts, int32) and ``rows`` the host-compacted
        ``(sum(min(counts, capacity)), n_cols)`` float32 block in record
        order.  Append-only: steps arrive in ascending order."""

    def event_result(self) -> dict[str, EventLog] | None:
        """Materialized event logs keyed by feature, or None for
        streaming sinks."""
        return None

    def commit(self, plan: ShardPlan, step: int,
               agg: dict[str, np.ndarray], live: float) -> None:
        pass

    def result(self) -> dict[str, np.ndarray] | None:
        """Feature arrays keyed by name, or None for streaming sinks."""
        return None

    def close(self) -> None:
        """Flush and release resources; safe to call more than once."""


class MemorySink(Sink):
    """Plain numpy arrays, one (n_records, *shape) per feature."""

    wants_commit = False

    def __init__(self):
        self.arrays: dict[str, np.ndarray] | None = None
        self._n_records = 0
        self._events: dict[str, dict] = {}

    def open(self, m, p, shapes, plan):
        self._n_records = m.n_records
        self._events = {}
        self.arrays = {name: np.zeros((m.n_records,) + shape, np.float32)
                       for name, shape in shapes.items()}

    def open_events(self, layouts):
        # rows are keyed by record, so the materialized log is in record
        # order whatever order the steps deliver records in
        self._events = {
            name: {"columns": cols, "capacity": cap,
                   "counts": np.zeros(self._n_records, np.int32),
                   "rows": {}}
            for name, (cols, cap) in layouts.items()}

    def write_events(self, step, indices, values):
        for name, (counts, rows) in values.items():
            ev = self._events[name]
            ev["counts"][indices] = counts
            kept = np.minimum(counts, ev["capacity"])
            offs = np.concatenate([[0], np.cumsum(kept)])
            rows = np.asarray(rows, np.float32)
            for i, rec in enumerate(np.asarray(indices)):
                ev["rows"][int(rec)] = rows[offs[i]:offs[i + 1]]

    def event_result(self):
        out = {}
        for name, ev in self._events.items():
            parts = [ev["rows"][r] for r in sorted(ev["rows"])]
            rows = (np.concatenate(parts) if parts
                    else np.zeros((0, len(ev["columns"])), np.float32))
            out[name] = EventLog(counts=ev["counts"], rows=rows,
                                 columns=ev["columns"],
                                 capacity=ev["capacity"])
        return out

    def write(self, step, indices, values):
        for name, vals in values.items():
            self.arrays[name][indices] = vals

    def result(self):
        return self.arrays


class StoreSink(Sink):
    """Resumable memmap-backed sink over :class:`FeatureStore`.

    The store keeps one ``(n_records, *shape)`` memmap per feature and
    commits a cursor plus the reduction carry after every step, so a
    killed job restarts where it stopped.  The on-disk layout is the
    reference package's, so either package resumes the other's store.
    """

    resumable = True

    def __init__(self, store: FeatureStore | str):
        self.store = FeatureStore(store) if isinstance(store, str) else store
        self.arrays: dict[str, np.memmap] | None = None
        self.window_arrays: dict[str, np.memmap] = {}
        self._plan: ShardPlan | None = None
        self._n_records = 0
        self._event_meta: dict[str, tuple[tuple[str, ...], int]] = {}

    def set_instrument(self, instrument):
        # the store refuses a calibration that differs from the one its
        # committed cursor was written under
        self.store.set_instrument(instrument)

    def describe(self):
        return {"format": "store", "path": self.store.root}

    def open(self, m, p, shapes, plan):
        self._plan = plan
        self._n_records = m.n_records
        committed = self.store.committed_steps(plan)
        if committed > 0:
            # a feature added after the cursor advanced has no data for
            # the committed steps — refuse before any file is created
            missing = sorted(n for n in shapes
                             if not self.store.array_exists(n))
            if missing:
                raise ValueError(
                    f"cannot resume: features {missing} have no data "
                    f"for the {committed} already-committed steps "
                    f"(added after the store was written?); use a fresh "
                    f"store directory or drop them from the job")
        self.arrays = self.store.open_arrays(
            {name: (m.n_records,) + shape for name, shape in shapes.items()},
            extend=True)

    def open_windows(self, shapes):
        # a mid-window resume restores window content from the committed
        # carry, not from these arrays: stale rows are overwritten
        self.window_arrays = self.store.open_arrays(shapes, extend=True)

    def write_windows(self, name, start, values):
        self.window_arrays[name][start:start + len(values)] = values

    def open_events(self, layouts):
        committed = self.store.committed_steps(self._plan)
        if committed > 0:
            # as for dense features in open(): a ragged feature added
            # after the cursor advanced has no rows for the committed
            # prefix, and resuming would publish a truncated log
            missing = sorted(n for n in layouts
                             if not self.store.event_log_exists(n))
            if missing:
                raise ValueError(
                    f"cannot resume: event logs {missing} have no data "
                    f"for the {committed} already-committed steps "
                    f"(added after the store was written?); use a fresh "
                    f"store directory or drop them from the job")
        self._event_meta = dict(layouts)
        self.store.open_events(
            {name: (self._n_records, len(cols))
             for name, (cols, _cap) in layouts.items()})

    def write_events(self, step, indices, values):
        for name, (counts, rows) in values.items():
            self.store.append_events(name, indices, counts, rows)

    def event_result(self):
        out = {}
        order = self._plan.record_order() if self._plan is not None \
            else None
        for name, (cols, cap) in self._event_meta.items():
            counts, rows = self.store.read_events(name)
            if order is not None:
                # the durable log is append-ordered (step-major across
                # a partition's spans); materialize it in record order
                rows = reorder_event_rows(counts, rows, cap, order)
            out[name] = EventLog(counts=counts, rows=rows, columns=cols,
                                 capacity=cap)
        return out

    def close(self):
        self.store.close_events()

    def resume_state(self):
        start = self.store.committed_steps(self._plan)
        if start <= 0:
            return 0, None
        return start, self.store.load_agg()

    def committed_steps(self, plan) -> int:
        return self.store.committed_steps(plan)

    def committed_plan(self) -> dict | None:
        return self.store.load_plan()

    def write(self, step, indices, values):
        for name, vals in values.items():
            self.arrays[name][indices] = vals

    def commit(self, plan, step, agg, live):
        self.store.commit_state(plan, step, agg, live)

    def result(self):
        return self.arrays


class CallbackSink(Sink):
    """Streaming sink: ``fn(step, indices, values)`` per step, nothing
    retained.  ``on_windows(name, start, values)``, when given, also
    streams finalized window rows as they close, and
    ``on_events(step, indices, values)`` each step's event-log slice."""

    wants_commit = False

    def __init__(self, fn: Callable[[int, np.ndarray, dict], None],
                 on_windows: Callable[[str, int, np.ndarray],
                                      None] | None = None,
                 on_events: Callable[[int, np.ndarray, dict],
                                     None] | None = None):
        self.fn = fn
        self.on_windows = on_windows
        self.on_events = on_events
        # mid-job window flushes ride commit boundaries
        self.wants_commit = on_windows is not None

    def write(self, step, indices, values):
        self.fn(step, indices, values)

    def write_windows(self, name, start, values):
        if self.on_windows is not None:
            self.on_windows(name, start, values)

    def write_events(self, step, indices, values):
        if self.on_events is not None:
            self.on_events(step, indices, values)


class AsyncSink(Sink):
    """Bounded background writer around any sink.

    ``write``/``write_windows``/``write_events``/``commit`` enqueue onto
    a FIFO processed by one worker thread, so the driver returns at once
    instead of blocking on sink IO; the bounded queue (``queue_size``
    steps) applies backpressure when the sink cannot keep up.  The queue
    is strictly FIFO with one consumer, so the inner sink sees exactly
    the engine's order: every ``write(step=k)`` lands before
    ``commit(step=k)``, and a commit runs (and so becomes durable) only
    after ALL earlier writes landed.  A crash leaves the resumable
    store's cursor at a step whose data is fully on disk: the crash
    semantics of the synchronous path, shifted in time.

    A worker exception is kept and re-raised on the *next* driver call
    (``write``/``commit``/``flush``/``result``/``close``), so a sink
    failure still aborts the job instead of vanishing on a thread.

    ``open``/``resume_state``/``committed_steps``/``committed_plan``
    stay synchronous: resume decisions need the inner sink's durable
    state, not the queue's view of it.
    """

    def __init__(self, inner: Sink, queue_size: int = 8,
                 name: str | None = None):
        self.inner = inner
        self.resumable = inner.resumable
        self.wants_commit = inner.wants_commit
        self._name = name or "AsyncSink"
        # bound by STEPS: a step enqueues a write plus, for
        # commit-consuming sinks, a commit
        items_per_step = 2 if self.wants_commit else 1
        self._q: queue.Queue = queue.Queue(
            maxsize=max(1, queue_size) * items_per_step)
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        self._killed = False

    # -- worker ---------------------------------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._killed or self._error is not None:
                    continue          # drain without executing
                op, args = item
                try:
                    if op == "write":
                        self.inner.write(*args)
                    elif op == "windows":
                        self.inner.write_windows(*args)
                    elif op == "events":
                        self.inner.write_events(*args)
                    else:
                        self.inner.commit(*args)
                except BaseException as e:     # noqa: BLE001 - re-raised
                    self._error = e
            finally:
                self._q.task_done()

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._run, name=f"{self._name}-writer", daemon=True)
            self._worker.start()

    def _raise_pending(self):
        # STICKY: once the inner sink failed, every later driver call
        # re-raises and the worker drains without executing.  Clearing
        # it would let a commit queued behind the failed write reach the
        # store — a durable cursor past data that never landed.
        if self._error is not None:
            raise RuntimeError("AsyncSink worker failed") from self._error

    # -- synchronous control plane --------------------------------------
    def set_instrument(self, instrument):
        self.inner.set_instrument(instrument)

    def open(self, m, p, shapes, plan):
        self.inner.open(m, p, shapes, plan)
        self._killed = False
        self._error = None        # a fresh run starts with a clean slate
        self._ensure_worker()

    def open_windows(self, shapes):
        self.inner.open_windows(shapes)

    def open_window_edges(self, edges):
        self.inner.open_window_edges(edges)

    def open_events(self, layouts):
        self.inner.open_events(layouts)

    def describe(self):
        return self.inner.describe()

    def resume_state(self):
        return self.inner.resume_state()

    def committed_steps(self, plan) -> int:
        self.flush()
        return self.inner.committed_steps(plan)

    def committed_plan(self) -> dict | None:
        self.flush()
        return self.inner.committed_plan()

    # -- queued data plane ----------------------------------------------
    def write(self, step, indices, values):
        self._raise_pending()
        self._q.put(("write", (step, indices, values)))

    def write_windows(self, name, start, values):
        # the same FIFO: a window row lands before the commit that makes
        # its cursor durable
        self._raise_pending()
        self._q.put(("windows", (name, start, values)))

    def write_events(self, step, indices, values):
        # FIFO again: the store's append position at commit(step=k) is
        # exactly the rows of steps <= k
        self._raise_pending()
        self._q.put(("events", (step, indices, values)))

    def commit(self, plan, step, agg, live):
        self._raise_pending()
        self._q.put(("commit", (plan, step, agg, live)))

    def flush(self):
        """Block until every queued write/commit has been applied."""
        if self._worker is not None:
            self._q.join()
        self._raise_pending()

    def result(self):
        self.flush()
        return self.inner.result()

    def event_result(self):
        self.flush()
        return self.inner.event_result()

    def close(self):
        """Drain the queue, stop the worker, close the inner sink — then
        re-raise the sticky worker error.  Cleanup runs to the end even
        for a failed sink, and the sticky error wins over any secondary
        error ``inner.close()`` raises."""
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
            self._q.put(None)
            self._worker.join()
        self._worker = None
        try:
            self.inner.close()
        finally:
            self._raise_pending()

    def _abort(self):
        """Crash simulation (tests): stop the worker WITHOUT draining.

        Queued-but-unprocessed writes/commits are discarded, as a process
        kill discards them; the durable state is whatever the worker had
        already applied.
        """
        self._killed = True
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join()
        self._worker = None


def as_sink(sink) -> Sink:
    """Normalize a user-supplied sink (see module docstring)."""
    if sink is None:
        return MemorySink()
    if isinstance(sink, Sink):
        return sink
    if isinstance(sink, (FeatureStore, str)):
        return StoreSink(sink)
    if callable(sink):
        return CallbackSink(sink)
    raise TypeError(f"cannot interpret {type(sink).__name__} as a Sink")
