"""Partitioned execution plans — the data-parallel layout layer.

The paper's cluster scales because HDFS hands each worker whole file
blocks: a worker reads *its own files*, start to finish, and the only
cross-worker traffic is the final timestamp join.  This module is that
layout decision made explicit.  A :class:`PartitionPlan` splits the
manifest's record index space into ``n_shards`` **contiguous spans cut
at file boundaries** (one :class:`WorkerSlice` per data-parallel
coordinate), in contrast to :class:`~repro_torch.core.manifest.ShardPlan`'s
interleaved chunks — so shard ``s`` touches only the files its span
overlaps, and the loader's file-boundary task splitting naturally keeps
every read local to one slice.

Determinism across device counts is the load-bearing property: the
partition is a pure function of ``(manifest, n_shards, chunk_records)``
and the jitted step's payload layout is ``(n_shards, chunk, record)``
regardless of how many *physical* devices the shards land on.  Running
the same plan over 1, 2, 4 or 8 devices only changes the
``NamedSharding`` of the same arrays through the same program — which
is why an N-device run is bitwise-identical to the 1-device run, and
why a job checkpointed at N devices resumes bitwise at M (the engine
re-reads the committed plan geometry and lays it over the new mesh; see
``engine.JobStepper.start``).

Progress accounting: commits are per *step* (one chunk from every
shard), so the single-integer resume cursor becomes a **low watermark**
— the smallest record index not yet committed.  ``cursor_after`` keeps
the window-flush logic conservative and exact (a window flushes only
when every record below its right edge is durable); the explicit
``step`` + per-shard cursors in the commit record carry the rest.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.manifest import DatasetManifest, ShardPlan


@dataclasses.dataclass(frozen=True)
class WorkerSlice:
    """One data-parallel worker's contiguous span of the record space."""

    index: int                 # data-axis coordinate
    lo: int                    # first global record of the span
    hi: int                    # one past the last
    file_lo: int               # first manifest file the span overlaps
    file_hi: int               # one past the last overlapped file

    @property
    def n_records(self) -> int:
        return self.hi - self.lo

    @property
    def n_files(self) -> int:
        return self.file_hi - self.file_lo


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Contiguous per-shard spans over [start, stop), stepped in chunks.

    ``offsets`` are the ``n_shards + 1`` span cut points
    (``offsets[0] == start``, ``offsets[-1] == stop``).  Shard ``s``
    owns records ``[offsets[s], offsets[s+1])`` and reads them
    ``chunk_records`` at a time; shards shorter than the longest one pad
    their trailing slots with index ``stop`` (readers return zeros for
    out-of-range indices and ``step_mask`` masks the contributions to
    reduction identities — same convention as ShardPlan's tail padding).

    The interface is ShardPlan's, so the engine, sources, loader, and
    store drive either plan unchanged.
    """

    start: int
    stop: int
    chunk_records: int
    offsets: tuple[int, ...]

    def __post_init__(self):
        off = tuple(int(o) for o in self.offsets)
        object.__setattr__(self, "offsets", off)
        if len(off) < 2 or off[0] != self.start or off[-1] != self.stop:
            raise ValueError(
                f"offsets must run from start to stop: got {off} for "
                f"[{self.start}, {self.stop})")
        if any(b < a for a, b in zip(off, off[1:])):
            raise ValueError(f"offsets must be non-decreasing: {off}")
        if self.chunk_records < 1:
            raise ValueError("chunk_records must be >= 1")

    # -- geometry ------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.offsets) - 1

    @functools.cached_property
    def shard_lengths(self) -> np.ndarray:
        return np.diff(np.asarray(self.offsets, np.int64))

    @property
    def n_live(self) -> int:
        return max(self.stop - self.start, 0)

    @property
    def records_per_step(self) -> int:
        return self.n_shards * self.chunk_records

    @property
    def n_steps(self) -> int:
        longest = int(self.shard_lengths.max()) if self.n_shards else 0
        return -(-longest // self.chunk_records)           # ceil

    @property
    def balance_ratio(self) -> float:
        """max shard records / mean shard records — 1.0 is a perfectly
        balanced partition (the number Fig 3.2 prints and the paper's
        speedup bound divides by)."""
        if self.n_live == 0:
            return 1.0
        return float(self.shard_lengths.max()
                     / (self.n_live / self.n_shards))

    def slices(self, m: DatasetManifest) -> tuple[WorkerSlice, ...]:
        """The per-worker spans with their file footprints."""
        fo = m.file_offsets
        out = []
        for s in range(self.n_shards):
            lo, hi = self.offsets[s], self.offsets[s + 1]
            if hi <= lo:
                out.append(WorkerSlice(s, lo, hi, 0, 0))
                continue
            f_lo = int(np.searchsorted(fo, lo, side="right")) - 1
            f_hi = int(np.searchsorted(fo, hi, side="left"))
            out.append(WorkerSlice(s, lo, hi, f_lo, f_hi))
        return tuple(out)

    # -- stepping ------------------------------------------------------
    def step_indices(self, step: int) -> np.ndarray:
        """(n_shards, chunk) global record indices; exhausted shards'
        slots carry the padding index ``stop``."""
        local = step * self.chunk_records \
            + np.arange(self.chunk_records, dtype=np.int64)[None, :]
        base = np.asarray(self.offsets[:-1], np.int64)[:, None]
        live = local < self.shard_lengths[:, None]
        return np.where(live, base + local, self.stop)

    def step_mask(self, step: int) -> np.ndarray:
        local = step * self.chunk_records \
            + np.arange(self.chunk_records, dtype=np.int64)[None, :]
        return local < self.shard_lengths[:, None]

    def shard_cursors(self, step: int) -> list[int]:
        """Per-shard next-unread global index after committing steps
        0..step (inclusive); ``offsets[s+1]`` when shard s is done."""
        done = min(step + 1, self.n_steps) * self.chunk_records
        c = np.minimum(self.shard_lengths, max(done, 0))
        return [int(o + n) for o, n in zip(self.offsets[:-1], c)]

    def cursor_after(self, step: int) -> int:
        """Low-watermark resume cursor: the smallest record index NOT
        yet committed after steps 0..step.  Every record below it is
        durable (shards advance in lockstep chunks), which is exactly
        the invariant the window-flush logic needs."""
        cursors = self.shard_cursors(step)
        pending = [c for c, hi in zip(cursors, self.offsets[1:]) if c < hi]
        return min(pending) if pending else self.stop

    def committed_records(self, step: int) -> int:
        """Total records covered by committed steps 0..step."""
        if step < 0:
            return 0
        done = min(step + 1, self.n_steps) * self.chunk_records
        return int(np.minimum(self.shard_lengths, done).sum())

    def record_order(self) -> np.ndarray:
        """Global record ids in the order steps deliver them (step-major,
        then shard, then position-in-chunk) — the append order of the
        event log, used to permute its rows back into record order."""
        ids = np.arange(self.start, self.stop, dtype=np.int64)
        if ids.size == 0:
            return ids
        s = np.searchsorted(np.asarray(self.offsets, np.int64), ids,
                            side="right") - 1
        local = ids - np.asarray(self.offsets, np.int64)[s]
        key = ((local // self.chunk_records)
               * (self.n_shards * self.chunk_records)
               + s * self.chunk_records + local % self.chunk_records)
        return ids[np.argsort(key, kind="stable")]


def _cut_points(n_records: int, file_offsets: np.ndarray,
                n_slices: int) -> list[int]:
    """Interior cut points: nearest file boundary to each ideal split,
    falling back to record granularity when the file layout cannot
    provide a strictly-increasing boundary (e.g. one huge file)."""
    bounds = np.asarray(file_offsets, np.int64)
    cuts = [0]
    for i in range(1, n_slices):
        ideal = int(round(i * n_records / n_slices))
        # keep cuts strictly increasing and leave >= 1 record per
        # remaining slice whenever the record count allows it
        lo = cuts[-1] + 1
        hi = n_records - (n_slices - i)
        if hi < lo:
            cuts.append(min(max(ideal, cuts[-1]), n_records))
            continue
        j = np.searchsorted(bounds, ideal)
        best = None
        for cand in (bounds[j - 1] if j > 0 else None,
                     bounds[j] if j < len(bounds) else None):
            if cand is None or not (lo <= int(cand) <= hi):
                continue
            if best is None or abs(int(cand) - ideal) < abs(best - ideal):
                best = int(cand)
        cuts.append(best if best is not None
                    else min(max(ideal, lo), hi))
    return cuts[1:]


def build_partition(m: DatasetManifest, n_shards: int,
                    chunk_records: int) -> PartitionPlan:
    """Split the manifest into ``n_shards`` contiguous spans cut at file
    boundaries where possible (guaranteed whenever
    ``max(file records) < n_records / (2 * n_shards)`` — the hypothesis
    suite holds that line), balanced toward ``n_records / n_shards``
    records per shard."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n = m.n_records
    cuts = _cut_points(n, m.file_offsets, n_shards)
    return PartitionPlan(start=0, stop=n, chunk_records=chunk_records,
                         offsets=(0, *cuts, n))


def plan_from_state(state: dict) -> "PartitionPlan | ShardPlan":
    """Rebuild the plan a committed cursor described (the ``"plan"``
    mapping of ``cursor.json``).  Partitioned plans round-trip their
    span offsets; legacy cursors (no ``offsets``) rebuild the
    interleaved ShardPlan they were written under."""
    if "offsets" in state:
        return PartitionPlan(start=int(state["start"]),
                             stop=int(state["stop"]),
                             chunk_records=int(state["chunk_records"]),
                             offsets=tuple(state["offsets"]))
    return ShardPlan(start=int(state["start"]), stop=int(state["stop"]),
                     n_shards=int(state["n_shards"]),
                     chunk_records=int(state["chunk_records"]))


def adopt_plan(current, committed: dict | None):
    """Re-partition on resume: the committed plan's geometry wins.

    A checkpoint fixes the logical shard layout for the rest of the job
    — that is what makes resuming at a different device count bitwise
    (the same ``(n_shards, chunk)`` program replays, only the shardings
    change).  A committed plan that covers a different record range
    means the manifest changed under the store, which is refused."""
    if committed is None:
        return current
    rebuilt = plan_from_state(committed)
    if (rebuilt.start, rebuilt.stop) != (current.start, current.stop):
        raise ValueError(
            f"cannot resume: the committed plan covers records "
            f"[{rebuilt.start}, {rebuilt.stop}) but this job plans "
            f"[{current.start}, {current.stop}) — the dataset changed "
            f"since the cursor was written; use a fresh store directory")
    return rebuilt



# -- device placement ----------------------------------------------------
#
# In the port a placement is an ordered tuple of executors, one
# ``torch.device`` each (repeats allowed: one card, or the CPU, can host
# several).  Executor ``e`` of ``D`` owns the ``n_shards / D``
# consecutive logical shard rows ``[e * n_shards / D, (e + 1) *
# n_shards / D)`` of every step.

def shard_sharding(mesh, data_axes: tuple[str, ...]) -> tuple:
    """The executors that lay a plan's leading shard axis over the
    mesh's data axes, in row order: one device per data coordinate (the
    device at index 0 of every other axis, which the port replicates
    over)."""
    names = tuple(mesh.axis_names)
    missing = [a for a in data_axes if a not in names]
    if missing:
        raise ValueError(f"data axes {missing} are not axes of the mesh "
                         f"{names}")
    perm = [names.index(a) for a in data_axes] \
        + [i for i, a in enumerate(names) if a not in data_axes]
    grid = np.transpose(np.asarray(mesh.devices, dtype=object), perm)
    n = data_parallel_size(mesh, data_axes)
    return tuple(grid.reshape(n, -1)[:, 0].tolist())


def data_parallel_size(mesh, data_axes: tuple[str, ...]) -> int:
    n = 1
    for a in data_axes:
        n *= mesh.shape[a]
    return n


def split_rows(x: np.ndarray, n_executors: int) -> list[np.ndarray]:
    """One step's host array, ``(n_shards, chunk, ...)``, as the row
    blocks its executors receive: block ``e`` holds shard rows ``[e *
    n_shards / n_executors, (e + 1) * n_shards / n_executors)`` — views,
    no copy.  The single-process counterpart of the reference's
    ``ship``: each executor is handed only its own rows."""
    n = x.shape[0]
    if n_executors < 1 or n % n_executors:
        raise ValueError(f"{n} shard rows cannot be split evenly over "
                         f"{n_executors} executor(s)")
    per = n // n_executors
    return [x[e * per:(e + 1) * per] for e in range(n_executors)]
