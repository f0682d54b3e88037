"""Host-side prefetching loader with speculative execution.

A copy of the reference's ``data/loader.py`` (numpy and threads only),
with its imports rewritten.

Spark mitigates stragglers by re-launching slow tasks on other executors
and taking whichever copy finishes first.  On the GPU the device step is
one program over the whole chunk (no intra-step stragglers by
construction), so stragglers live in the HOST input pipeline — slow
disks, slow decode.  This loader reproduces Spark's
two answers at that layer:

  * over-decomposition: each plan step is split into ``overdecompose``
    read tasks scheduled on a shared read pool, so a slow read only delays
    its own sub-slice (work stealing comes free from the shared pool queue);
  * speculative re-execution: when a task's runtime exceeds
    ``speculate_factor`` x the running median, a duplicate is launched;
    first completion wins.  Reads are pure functions of the record index
    (the lineage property), so duplicates are safe.

Prefetch depth ``depth`` overlaps host IO with device compute — the
compute/communication-overlap trick applied at the data layer.

The loader is payload-dtype agnostic: task results are concatenated and
reshaped as-is, so a reader returning raw ``<i2`` PCM (the int16
transport path) streams through byte-for-byte — over-decomposition and
speculation never force a float conversion or an extra copy.

Threading note: orchestration (step assembly, speculation timers) runs on a
dedicated pool, actual reads on another.  A single shared pool would
self-deadlock — wrappers would occupy every worker while waiting on read
tasks that can never be scheduled.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.core.manifest import ShardPlan
from repro_torch.faults.errors import is_retryable


class SpeculativeLoader:
    def __init__(self, reader: Callable[[np.ndarray], np.ndarray],
                 plan: ShardPlan, workers: int = 4,
                 overdecompose: int = 4, depth: int = 2,
                 speculate_factor: float = 4.0,
                 min_speculate_sec: float = 0.05,
                 boundaries: np.ndarray | None = None,
                 retries: int = 1):
        self.reader = reader
        self.plan = plan
        self.overdecompose = max(1, overdecompose)
        # fresh re-submissions allowed per read task after EVERY copy
        # (original + speculative duplicate) failed with a retryable
        # error — Spark's task.maxFailures at the read-task level.
        # Non-retryable failures propagate immediately regardless.
        self.retries = max(0, retries)
        # sorted global record offsets at which a new file/block begins
        # (a manifest's ``file_offsets``); when given, read tasks split
        # along these boundaries — the HDFS block-locality analogue
        self.boundaries = None if boundaries is None \
            else np.asarray(boundaries, np.int64)
        self.depth = max(1, depth)
        self.speculate_factor = speculate_factor
        self.min_speculate_sec = min_speculate_sec
        # reads never block on other tasks -> safe in one pool;
        # step assembly blocks on reads -> must live in its own pool.
        # Named prefixes let close() verification (and thread dumps of a
        # long-lived service) attribute every worker to its loader.
        self.read_pool = cf.ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="SpecLoader-read")
        self.step_pool = cf.ThreadPoolExecutor(
            max_workers=self.depth, thread_name_prefix="SpecLoader-step")
        self.durations: list[float] = []
        self.speculated = 0
        self.read_retries = 0
        self._lock = threading.Lock()

    # -- one read task (leaf work, runs on read_pool) -------------------
    def _timed_read(self, idx: np.ndarray) -> np.ndarray:
        t0 = time.monotonic()
        out = self.reader(idx)
        with self._lock:
            self.durations.append(time.monotonic() - t0)
        return out

    def _split_step(self, flat: np.ndarray) -> list[np.ndarray]:
        """Split one step's record indices into read tasks.

        Without ``boundaries``: ~equal arbitrary slices.  With them:
        cut wherever the indices cross a file/block boundary first, so a
        read task never straddles two files (each task coalesces into
        sequential IO on one handle), then rebalance toward
        ``overdecompose`` tasks — file runs larger than the target size
        are re-split at record granularity (a one-file dataset still
        over-decomposes), adjacent smaller runs merge up to the target
        (a many-tiny-files dataset doesn't explode the task count).

        The cut logic only compares *consecutive* elements, so it needs
        no global ordering: a partitioned plan's step — one contiguous
        chunk per worker span, exhausted spans padded with the
        out-of-range index ``stop`` — splits into per-span, per-file
        tasks (padding runs land in their own task and read as zeros),
        which is what keeps every read local to one worker's files.
        """
        if self.boundaries is None:
            return [p for p in np.array_split(flat, self.overdecompose)
                    if p.size]
        target = -(-flat.size // self.overdecompose)       # ceil
        fid = np.searchsorted(self.boundaries, flat, side="right")
        cuts = np.nonzero(np.diff(fid))[0] + 1
        parts: list[np.ndarray] = []
        for run in np.split(flat, cuts):
            if parts and parts[-1].size + run.size <= target:
                parts[-1] = np.concatenate([parts[-1], run])
                continue
            for i in range(0, run.size, target):
                parts.append(run[i:i + target])
        return [p for p in parts if p.size]

    def _recover(self, first: cf.Future, part: np.ndarray) -> np.ndarray:
        """Ride out a straggling or transiently-failing read task.

        Launches a duplicate of ``first`` and takes whichever copy
        SUCCEEDS first.  FIRST_COMPLETED can return a copy that *raised*
        (and ``done`` may hold both copies), so keep waiting while any
        copy is still running.  Only when every copy has failed does the
        bounded retry budget kick in: a retryable last failure buys up
        to ``retries`` fresh submissions (reads are pure, so re-reading
        is always sound); then — or immediately for non-retryable
        failures — the error is re-raised, naming its fault.
        """
        waiting = {first, self.read_pool.submit(self._timed_read, part)}
        retries_left = self.retries
        while True:
            done, waiting = cf.wait(waiting,
                                    return_when=cf.FIRST_COMPLETED)
            ok = next((f for f in done if not f.cancelled()
                       and f.exception() is None), None)
            if ok is not None:
                return ok.result()
            if waiting:
                continue
            failed = next(f for f in done if not f.cancelled())
            if retries_left > 0 and is_retryable(failed.exception()):
                retries_left -= 1
                with self._lock:
                    self.read_retries += 1
                waiting = {self.read_pool.submit(self._timed_read, part)}
                continue
            failed.result()             # every copy failed: re-raise

    # -- step assembly (runs on step_pool; blocks only on read_pool) ----
    def _load_step(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.plan.step_indices(step)
        flat = idx.reshape(-1)
        parts = self._split_step(flat)
        futs = {i: self.read_pool.submit(self._timed_read, p)
                for i, p in enumerate(parts)}
        results: dict[int, np.ndarray] = {}
        while len(results) < len(parts):
            with self._lock:
                med = (float(np.median(self.durations))
                       if self.durations else None)
            budget = None if med is None else max(
                self.speculate_factor * med, self.min_speculate_sec)
            for i, fut in list(futs.items()):
                if i in results:
                    continue
                try:
                    results[i] = fut.result(timeout=budget)
                # cf.TimeoutError is NOT the builtin TimeoutError until
                # Python 3.11; catch both spellings.
                except (cf.TimeoutError, TimeoutError):
                    # straggler: launch a duplicate, first SUCCESS wins
                    with self._lock:
                        self.speculated += 1
                    results[i] = self._recover(fut, parts[i])
                except BaseException as e:      # noqa: BLE001
                    # a copy FAILED (no timeout).  Transient read errors
                    # take the same recovery path as stragglers — a
                    # fresh copy may succeed (flaky disk, not bad data);
                    # everything else propagates untouched.
                    if not is_retryable(e):
                        raise
                    results[i] = self._recover(fut, parts[i])
        # dtype passes through untouched (int16 payloads stay int16)
        out = np.concatenate([results[i] for i in range(len(parts))], axis=0)
        return out.reshape(*idx.shape, -1), self.plan.step_mask(step)

    def iter_steps(self, start: int = 0, stop: int | None = None):
        """Yield (step, payload, mask) for plan steps [start, stop) in
        order, keeping ``depth`` steps in flight.

        The window form is what lets a resumed job prefetch from its
        committed cursor instead of step 0.  Abandoning the generator
        early (a preempted or failed consumer) cancels the still-queued
        step futures on the way out; ``close()`` then joins the pools so
        nothing keeps running behind the caller's back.
        """
        n = self.plan.n_steps if stop is None else min(stop,
                                                       self.plan.n_steps)
        pending: dict[int, cf.Future] = {}
        try:
            for step in range(start, min(start + self.depth, n)):
                pending[step] = self.step_pool.submit(self._load_step, step)
            for step in range(start, n):
                payload, mask = pending.pop(step).result()
                nxt = step + self.depth
                if nxt < n:
                    pending[nxt] = self.step_pool.submit(self._load_step,
                                                         nxt)
                yield step, payload, mask
        finally:
            for fut in pending.values():
                fut.cancel()

    def __iter__(self):
        """Yield (step, payload, mask) with ``depth`` steps of prefetch."""
        return self.iter_steps()

    def stats(self) -> dict:
        with self._lock:
            d = (np.asarray(self.durations) if self.durations
                 else np.zeros(1))
            spec = self.speculated
            retried = self.read_retries
        return {"tasks": int(d.size), "speculated": spec,
                "read_retries": retried,
                "median_s": float(np.median(d)),
                "p99_s": float(np.quantile(d, 0.99))}

    def close(self, wait: bool = True):
        """Shut both pools down; with ``wait`` (the default) block until
        every worker thread has exited.

        Queued tasks are cancelled; already-running reads finish their
        current call and the step-assembly wrappers waiting on them
        unwind via ``CancelledError``/pool-shutdown errors.  A consumer
        that abandons ``iter_steps`` mid-job (scheduler preemption, a
        failed tenant) therefore leaves NO orphaned executor threads or
        in-flight futures behind — the contract the serving layer's
        per-tenant isolation depends on.  ``wait=False`` keeps the old
        fire-and-forget behavior for interactive teardown.

        Read pool first: cancelling its queue makes the step-assembly
        wrappers blocked on those futures unwind via ``CancelledError``
        immediately, instead of waiting for every queued read to run.
        """
        self.read_pool.shutdown(wait=wait, cancel_futures=True)
        self.step_pool.shutdown(wait=wait, cancel_futures=True)
