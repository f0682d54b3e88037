"""LiveSource — real-time streams as first-class job input.

The DCL real-time systems (Dugan et al.) process live hydrophone feeds
next to batch archives; this source is that ingest path for the job
engine.  A producer (socket reader, acquisition callback, another
thread) ``push``\\ es records *in global record order* into a bounded
ring buffer; the engine consumes them through the normal
:class:`~repro_torch.api.sources.Source` protocol, so a live tenant runs
beside ``WavSource`` batch tenants in one service with the same jitted
step, windows flushing incrementally to its sink as they close.

Semantics:

  * **bounded ring, backpressure on overrun** — the ring holds
    ``capacity`` records; ``push`` blocks once the producer runs
    ``capacity`` records ahead of the consumer, and raises on timeout
    (never silently drops or overwrites unread audio);
  * **graceful end-of-stream** — ``end()`` marks the stream finite;
    ``stream_end()`` then tells the engine to mask out never-arriving
    records and finish the job with whatever did arrive (partial final
    windows flush like any trailing window);
  * **mid-stream resume** — a stream resumed after a crash constructs
    ``LiveSource(..., start=cursor)`` and the producer re-feeds from
    the committed cursor; because the engine's carry rides commits, the
    resumed accumulation is bitwise-identical to an uninterrupted run
    over the same records;
  * **non-blocking polling** — ``poll(indices)`` reports whether a
    fetch would block, which is how the service scheduler skips a
    starved live tenant instead of stalling every other tenant;
  * **filling in place** — ``fetch_into(indices, out)`` copies each
    record into the caller's buffer (the engine's pinned staging slot)
    as soon as it lands, outside the ring's lock, so a step's earlier
    records are in place before its last one arrives.

Payload transport mirrors the batch sources: ``payload_dtype="int16"``
rings raw PCM with a per-record decode-scale sidecar (push the scale
alongside each record), ``"float32"`` rings decoded waveforms.

With :mod:`repro_torch.trace` on, the ring keeps each record's push
stamp (``perf_counter_ns`` once its copy is in) in a sidecar beside the
decode scales, and records spans: on the producer's thread
``source.push`` (attribute ``record``, the first record pushed) with a
``source.push_wait`` child for the wait for the lock and one for each
wait for room; on the consumer's ``source.wait`` (attribute
``ready_ns`` on the last wait of a fetch: the push stamp of the last
live record the fetch waited for) and ``source.copy`` (one copy out of
the ring, made outside its lock; attributes ``records``, how many it
copied, and ``early``, true when a record of the fetch had still to
land as it began).  Tracing off, no stamp is written.
"""
from __future__ import annotations

import threading
import time
from typing import Iterable

import numpy as np

from repro_torch import trace
from repro_torch.api.sources import Source
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams, PCM_DECODE_SCALE
from repro_torch.faults.errors import StreamStall


class RingOverrun(RuntimeError):
    """Producer overran the ring and backpressure timed out (or was
    declined with ``timeout=0``)."""


class LiveSource(Source):
    """Bounded ring-buffer source fed by ``push``; see module docstring.

    ``capacity`` is in records and must hold at least one full plan step
    (``n_shards * chunk`` records) — fetch needs a whole step resident.
    ``start`` is the first global record this stream delivers (the
    committed cursor when resuming).  ``fetch_timeout`` bounds how long
    a blocking fetch waits for the producer before raising — a starved
    tenant inside a service is skipped via ``poll`` and never hits it.
    """

    def __init__(self, record_size: int, capacity: int = 64,
                 payload_dtype: str = "float32", start: int = 0,
                 fetch_timeout: float = 60.0):
        if payload_dtype not in ("float32", "int16"):
            raise ValueError(
                f"payload dtype must be 'float32' or 'int16', "
                f"got {payload_dtype!r}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.record_size = int(record_size)
        self.capacity = int(capacity)
        self.payload_dtype = payload_dtype
        self.fetch_timeout = fetch_timeout
        dt = np.int16 if payload_dtype == "int16" else np.float32
        self._buf = np.zeros((self.capacity, self.record_size), dt)
        self._scl = np.full(self.capacity, PCM_DECODE_SCALE, np.float32)
        self._stamp = np.zeros(self.capacity, np.int64)  # traced pushes
        # each slot's last record copied out, and its scale: the slot
        # may be refilled before the engine asks for the scale
        self._taken = np.full(self.capacity, -1, np.int64)
        self._taken_scl = np.zeros(self.capacity, np.float32)
        self._start = int(start)     # first global record of the stream
        self._pushed = int(start)    # next global record to be pushed
        self._consumed = int(start)  # records < this have been fetched
        self._reading: list[int] = []    # lowest record of each copy
        self._total: int | None = None   # set by end()
        self._bound: int | None = None   # manifest n_records after bind
        self._auto_ended = False         # close() ended it, not end()
        self._cond = threading.Condition()

    # -- producer side --------------------------------------------------
    @property
    def pushed(self) -> int:
        """Next global record index the producer will push."""
        with self._cond:
            return self._pushed

    @property
    def ended(self) -> bool:
        with self._cond:
            return self._total is not None

    def push(self, records: np.ndarray, scales=None,
             timeout: float | None = None) -> None:
        """Append the next record(s) of the stream, in order.

        ``records`` is one ``(record_size,)`` record or a
        ``(k, record_size)`` batch; on the int16 transport ``scales``
        optionally carries the matching per-record decode-scale(s).
        Blocks while the ring is full (the consumer is ``capacity``
        records behind); ``timeout`` seconds later — or immediately
        with ``timeout=0`` — raises :class:`RingOverrun` instead of
        dropping or overwriting unconsumed audio.
        """
        rec = np.asarray(records, self._buf.dtype)
        if rec.ndim == 1:
            rec = rec[None]
        if rec.ndim != 2 or rec.shape[1] != self.record_size:
            raise ValueError(
                f"push expects (record_size,) or (k, record_size) with "
                f"record_size={self.record_size}, got {rec.shape}")
        scl = None
        if scales is not None:
            scl = np.broadcast_to(
                np.asarray(scales, np.float32).reshape(-1), (len(rec),))
        with trace.span("source.push", record=self._pushed):
            with trace.span("source.push_wait"):     # for the lock
                self._cond.acquire()
            try:
                for i in range(len(rec)):
                    if self._total is not None:
                        raise RuntimeError(
                            "push() after end(): the stream is closed")
                    if self._bound is not None \
                            and self._pushed >= self._bound:
                        raise ValueError(
                            f"push beyond the manifest: the bound job "
                            f"covers records [{self._start}, "
                            f"{self._bound}) and record {self._pushed} "
                            f"is past the end — size the manifest for "
                            f"the stream's maximum length")
                    with trace.span("source.push_wait"):  # for room
                        ok = self._cond.wait_for(
                            lambda: self._total is not None
                            or self._pushed
                            - min([self._consumed, *self._reading])
                            < self.capacity,
                            timeout=timeout)
                    if self._total is not None:
                        # closed under our feet (consumer went away) —
                        # the producer must see it, not hang on
                        # backpressure
                        raise RuntimeError(
                            "push() after end(): the stream is closed")
                    if not ok:
                        raise RingOverrun(
                            f"ring full: producer is {self.capacity} "
                            f"records ahead of the consumer (record "
                            f"{self._pushed} blocked {timeout}s; "
                            f"consumer at {self._consumed})")
                    slot = self._pushed % self.capacity
                    self._buf[slot] = rec[i]
                    if scl is not None:
                        self._scl[slot] = scl[i]
                    if trace.active:
                        self._stamp[slot] = time.perf_counter_ns()
                    self._pushed += 1
                    self._cond.notify_all()
            finally:
                self._cond.release()

    def end(self) -> None:
        """Signal end-of-stream: no further records will arrive.  The
        engine finishes the job over what was delivered; idempotent."""
        with self._cond:
            if self._total is None:
                self._total = self._pushed
            self._cond.notify_all()

    def feed(self, records: Iterable[np.ndarray], scales=None,
             end: bool = True) -> None:
        """Convenience producer: push every record of ``records`` (an
        iterable of ``(record_size,)`` arrays), then ``end()`` the
        stream.  Run it on a producer thread for a real-time feed."""
        for i, rec in enumerate(records):
            self.push(rec, None if scales is None else scales[i])
        if end:
            self.end()

    # -- Source protocol (consumer side) --------------------------------
    def bind(self, m: DatasetManifest, p: DepamParams) -> "LiveSource":
        with self._cond:
            if self._auto_ended:
                # the previous consumer's close() ended the stream as
                # crash/teardown debris, not the producer's end(); a
                # re-admitted (restarted) tenant re-binds the same ring
                # and keeps consuming where the cursor left off
                self._total = None
                self._auto_ended = False
            self._bound = m.n_records
        return self

    def with_payload(self, dtype: str) -> "LiveSource":
        if dtype == self.payload_dtype:
            return self
        raise ValueError(
            f"LiveSource rings {self.payload_dtype!r} records; construct "
            f"it with payload_dtype={dtype!r} instead of converting a "
            f"live stream in flight")

    def stream_end(self) -> int | None:
        with self._cond:
            return self._total

    def _never_arrives(self, idx: np.ndarray) -> np.ndarray:
        """Mask of indices this stream will not deliver: beyond an
        ended stream, or beyond the bound manifest (padding slots)."""
        limit = self._total if self._total is not None else self._bound
        never = idx < self._start
        if limit is not None:
            never |= idx >= limit
        return never

    def poll(self, indices: np.ndarray) -> str:
        idx = np.asarray(indices, np.int64).reshape(-1)
        with self._cond:
            wanted = idx[~self._never_arrives(idx)]
            if wanted.size and wanted.max() >= self._pushed:
                return "pending"
            return "ready"

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        out = np.empty(idx.shape + (self.record_size,), self._buf.dtype)
        return self.fetch_into(idx, out)

    def fetch_into(self, indices: np.ndarray, out: np.ndarray) -> np.ndarray:
        """``fetch`` into ``out``, a C-contiguous array of the ring's
        dtype shaped ``indices.shape + (record_size,)``; returns ``out``.

        Each wanted record is copied as soon as it has landed: under the
        lock the fetch waits for the next one, notes which are present
        and marks them as under copy, then copies them outside the lock
        with slices of the ring, so the producer keeps pushing.  No slot
        under copy is refilled, ``_consumed`` advances after the last
        copy, and records that never arrive are zero-filled.
        """
        idx = np.asarray(indices, np.int64)
        flat = idx.reshape(-1)
        shape = idx.shape + (self.record_size,)
        if out.shape != shape or out.dtype != self._buf.dtype \
                or not out.flags.c_contiguous:
            raise ValueError(
                f"fetch_into needs a C-contiguous {self._buf.dtype} array "
                f"of shape {shape}, got {out.dtype} {out.shape}")
        rows = out.reshape(flat.size, self.record_size)
        copied = np.zeros(flat.size, bool)
        deadline = None if self.fetch_timeout is None \
            else time.monotonic() + self.fetch_timeout
        with self._cond:
            if (flat < self._start).any():
                raise ValueError(
                    f"fetch of record {flat.min()} before the stream "
                    f"start {self._start} — resume the job from the "
                    f"cursor the stream was constructed with")
            live = flat[~self._never_arrives(flat)]
            if live.size > self.capacity:
                raise ValueError(
                    f"one fetch asks for {live.size} live records but "
                    f"the ring holds {self.capacity} — capacity must "
                    f"cover a full plan step (n_shards * chunk)")
        while True:
            with self._cond:
                batch = self._landed(flat, copied, deadline)
                if batch is None:       # every live record is in place
                    done = flat[copied]
                    if done.size:
                        self._consumed = max(self._consumed,
                                             int(done.max()) + 1)
                        self._cond.notify_all()
                    break
                pos, early = batch
                low = int(flat[pos].min())
                self._reading.append(low)
            try:
                with trace.span("source.copy", records=int(pos.size),
                                early=early):
                    self._copy_out(rows, pos, flat[pos])
            finally:
                with self._cond:
                    self._reading.remove(low)
                    self._cond.notify_all()
            copied[pos] = True
        rows[~copied] = 0               # records that never arrive
        return out

    def _landed(self, flat: np.ndarray, copied: np.ndarray,
                deadline: float | None):
        """Under the lock: wait until the next wanted record has landed
        (or will never arrive), and return the positions in ``flat`` of
        the wanted records now in the ring, with whether another is
        still to land; None once nothing is left to copy."""
        def pending():
            return ~copied & ~self._never_arrives(flat)

        def next_landed():
            want = pending()
            return not want.any() or flat[want].min() < self._pushed

        if not pending().any():
            return None
        with trace.span("source.wait") as wait:
            ok = self._cond.wait_for(
                next_landed, timeout=None if deadline is None
                else max(0.0, deadline - time.monotonic()))
            want = pending()
            if not ok:
                # StreamStall (a TimeoutError) is RETRYABLE AT THE
                # TENANT LEVEL: a service with a RestartPolicy parks the
                # tenant and re-admits it from its committed cursor,
                # instead of one starved producer killing the job
                raise StreamStall(
                    f"live fetch starved: waited {self.fetch_timeout}s "
                    f"for record {int(flat[want].max())} "
                    f"(producer at {self._pushed}, no end() in sight)")
            if not want.any():          # end(): the rest never arrives
                return None
            here = want & (flat < self._pushed)
            early = bool((want & ~here).any())
            if wait and not early:
                wait.set(ready_ns=int(
                    self._stamp[int(flat[want].max()) % self.capacity]))
        sel = flat[here]
        if sel.min() < self._pushed - self.capacity:
            raise RingOverrun(
                f"record {int(sel.min())} already evicted from the ring "
                f"(producer at {self._pushed}, capacity {self.capacity}) "
                f"— the consumer fell a full ring behind")
        slots = sel % self.capacity
        self._taken[slots] = sel
        self._taken_scl[slots] = self._scl[slots]
        return np.flatnonzero(here), early

    def _copy_out(self, rows: np.ndarray, pos: np.ndarray,
                  recs: np.ndarray) -> None:
        """``rows[pos] = ring[recs]`` as slice copies: one per run of
        consecutive positions and records, two where the run wraps."""
        breaks = np.flatnonzero((np.diff(pos) != 1) | (np.diff(recs) != 1))
        for a, b in zip(np.r_[0, breaks + 1], np.r_[breaks + 1, pos.size]):
            p, n = int(pos[a]), int(b - a)
            s = int(recs[a]) % self.capacity
            k = min(n, self.capacity - s)
            rows[p:p + k] = self._buf[s:s + k]
            rows[p + k:p + n] = self._buf[:n - k]

    def scales(self, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        flat = idx.reshape(-1)
        out = np.full(flat.size, PCM_DECODE_SCALE, np.float32)
        with self._cond:
            have = ~self._never_arrives(flat)
            sel = flat[have]
            if sel.size and sel.max() < self._pushed:
                slots = sel % self.capacity
                out[have] = np.where(self._taken[slots] == sel,
                                     self._taken_scl[slots],
                                     self._scl[slots])
        return out.reshape(idx.shape)

    def close(self) -> None:
        """Consumer-side release: wake any blocked producer so it sees
        the stream as closed instead of hanging on backpressure."""
        with self._cond:
            if self._total is None:
                self._total = self._pushed
                self._auto_ended = True
            self._cond.notify_all()
