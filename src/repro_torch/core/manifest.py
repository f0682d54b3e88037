"""Record manifest + shard planner — the HDFS/YARN analogue.

The paper's system gets its scalability from HDFS splitting files into
blocks placed on the workers that process them ("adding more workers allows
to read more files in parallel").  Our equivalent is a *deterministic record
manifest*: a pure function record_index -> (file, offset) over the dataset,
plus a planner that carves the record index space into equal contiguous
shards, one per data-parallel device.

Datasets come in two layouts:

  * **uniform** — ``n_files`` files of ``records_per_file`` records each
    (synthetic miniatures; ``locate`` is a ``divmod``);
  * **variable** — ``file_records`` gives the per-file record count (the
    real 1807 x 45-min corpus is heterogeneous: clipped deployments,
    duty-cycled recorders).  ``locate`` becomes a binary search over the
    cumulative offsets, and ``file_names`` can pin arbitrary on-disk
    names discovered by ``repro.data.wavio.scan_dataset``.

Determinism is the fault-tolerance story (Spark lineage): any shard can be
recomputed from scratch by any worker because the mapping is stateless.
The planner also supports *elastic replanning* — given a committed cursor
and a new worker count, it produces a fresh balanced plan over the
remaining records (what YARN re-allocation + Spark dynamic allocation do).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetManifest:
    """A dataset of ``n_files`` wav-like files of known record counts.

    Uniform datasets set ``records_per_file``; variable datasets set
    ``file_records`` (one count per file, ``records_per_file`` ignored).
    Instances stay frozen/hashable — they key the engine's compile cache.
    """

    n_files: int
    records_per_file: int
    record_size: int          # samples per record
    fs: float
    seed: int = 0             # generation seed for synthetic datasets
    file_records: tuple[int, ...] | None = None   # variable layout
    file_names: tuple[str, ...] | None = None     # on-disk names
    file_starts: tuple[float, ...] | None = None  # UTC epoch s per file
    file_dropped: tuple[int, ...] | None = None   # tail frames dropped

    def __post_init__(self):
        if self.file_records is not None:
            if len(self.file_records) != self.n_files:
                raise ValueError(
                    f"file_records has {len(self.file_records)} entries "
                    f"for n_files={self.n_files}")
            if any(r < 0 for r in self.file_records):
                raise ValueError("file_records entries must be >= 0")
        if self.file_names is not None \
                and len(self.file_names) != self.n_files:
            raise ValueError(
                f"file_names has {len(self.file_names)} entries "
                f"for n_files={self.n_files}")
        if self.file_dropped is not None \
                and len(self.file_dropped) != self.n_files:
            raise ValueError(
                f"file_dropped has {len(self.file_dropped)} entries "
                f"for n_files={self.n_files}")
        if self.file_starts is not None:
            if len(self.file_starts) != self.n_files:
                raise ValueError(
                    f"file_starts has {len(self.file_starts)} entries "
                    f"for n_files={self.n_files}")
            self._validate_overlap()

    def _validate_overlap(self) -> None:
        """Overlapping recordings are a corpus defect, not a warning:
        two files claiming the same UTC instant would publish two values
        for one time coordinate.  (Files may legally abut or leave
        gaps — duty-cycled recorders do — but never overlap.)"""
        order = sorted(range(self.n_files),
                       key=lambda i: self.file_starts[i])
        for a, b in zip(order, order[1:]):
            # audible span includes tail frames dropped from the record
            # grid — they still occupy real time on the hydrophone
            span = (self.records_in_file(a) * self.record_size
                    + (self.file_dropped[a] if self.file_dropped else 0)
                    ) / self.fs
            end_a = self.file_starts[a] + span
            if self.file_starts[b] < end_a - 1e-9:
                raise ValueError(
                    f"timestamp overlap: {self.file_name(a)!r} (starts "
                    f"{self.file_starts[a]:.3f}, spans {span:.3f}s) "
                    f"overlaps {self.file_name(b)!r} (starts "
                    f"{self.file_starts[b]:.3f}) by "
                    f"{end_a - self.file_starts[b]:.3f}s — overlapping "
                    f"recordings cannot share one UTC time axis")

    @classmethod
    def from_files(cls, file_records, record_size: int, fs: float,
                   file_names=None, seed: int = 0, file_starts=None,
                   file_dropped=None) -> "DatasetManifest":
        """Variable-layout constructor: one record count per file."""
        fr = tuple(int(r) for r in file_records)
        return cls(n_files=len(fr), records_per_file=0,
                   record_size=record_size, fs=fs, seed=seed,
                   file_records=fr,
                   file_names=None if file_names is None
                   else tuple(file_names),
                   file_starts=None if file_starts is None
                   else tuple(float(t) for t in file_starts),
                   file_dropped=None if file_dropped is None
                   else tuple(int(d) for d in file_dropped))

    @property
    def n_records(self) -> int:
        if self.file_records is not None:
            return int(sum(self.file_records))
        return self.n_files * self.records_per_file

    @property
    def total_gb(self) -> float:
        """Workload size in GB assuming float32 samples (paper reports GB)."""
        return self.n_records * self.record_size * 4 / 1e9

    @functools.cached_property
    def file_offsets(self) -> np.ndarray:
        """Cumulative record offsets, shape (n_files + 1,): file ``i``
        owns global records [offsets[i], offsets[i+1])."""
        counts = np.asarray(self.file_records, np.int64) \
            if self.file_records is not None \
            else np.full(self.n_files, self.records_per_file, np.int64)
        return np.concatenate([[0], np.cumsum(counts)])

    def records_in_file(self, file_idx: int) -> int:
        if self.file_records is not None:
            return self.file_records[file_idx]
        return self.records_per_file

    def file_name(self, file_idx: int) -> str:
        if self.file_names is not None:
            return self.file_names[file_idx]
        return f"file_{file_idx:05d}.wav"

    def locate(self, record_idx: int) -> tuple[int, int]:
        """record index -> (file index, record-within-file index)."""
        if self.file_records is None:
            return divmod(record_idx, self.records_per_file)
        off = self.file_offsets
        fi = int(np.searchsorted(off, record_idx, side="right")) - 1
        return fi, int(record_idx - off[fi])

    def locate_many(self, record_idx: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``locate`` for a batch of indices (the block-IO
        hot path): returns (file indices, record-within-file indices)."""
        idx = np.asarray(record_idx, np.int64)
        off = self.file_offsets
        fi = np.searchsorted(off, idx, side="right") - 1
        return fi, idx - off[fi]

    # ---- absolute time axis ------------------------------------------

    @property
    def has_timestamps(self) -> bool:
        return self.file_starts is not None

    @functools.cached_property
    def _starts_array(self) -> np.ndarray:
        """Per-file start times, shape (n_files,): UTC epoch seconds
        when timestamped, else each file's offset into a relative axis
        that starts at 0 (contiguous, gap-free by construction)."""
        if self.file_starts is not None:
            return np.asarray(self.file_starts, np.float64)
        return self.file_offsets[:-1].astype(np.float64) \
            * (self.record_size / self.fs)

    def record_times(self, record_idx) -> np.ndarray:
        """Record indices -> start times in seconds (float64).

        UTC epoch seconds when the manifest is timestamped, else
        seconds since the start of the dataset — either way
        ``file_start + record_within_file * record_size / fs``, so
        window edges and event onsets are pure arithmetic on top.
        """
        idx = np.atleast_1d(np.asarray(record_idx, np.int64))
        fi, ri = self.locate_many(idx)
        return self._starts_array[fi] \
            + ri.astype(np.float64) * (self.record_size / self.fs)

    def coverage(self) -> list[tuple[float, float]]:
        """Merged audible intervals [start, end) in time order.

        Each file covers ``records * record_size + dropped_tail``
        samples of real time; abutting/overlap-free files merge into
        maximal contiguous intervals, so ``len(coverage()) - 1`` is the
        number of recording gaps.
        """
        spans = []
        for i in range(self.n_files):
            n = self.records_in_file(i) * self.record_size \
                + (self.file_dropped[i] if self.file_dropped else 0)
            if n == 0:
                continue
            start = float(self._starts_array[i])
            spans.append((start, start + n / self.fs))
        spans.sort()
        merged: list[tuple[float, float]] = []
        for start, end in spans:
            if merged and start <= merged[-1][1] + 1e-9:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        return merged

    def gap_seconds(self) -> float:
        """Total un-recorded time inside the dataset's UTC window."""
        cov = self.coverage()
        return sum(b[0] - a[1] for a, b in zip(cov, cov[1:]))

    def utc_window(self) -> tuple[float, float] | None:
        """(first start, last end) of the covered span, or None when
        the dataset is empty."""
        cov = self.coverage()
        if not cov:
            return None
        return cov[0][0], cov[-1][1]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Balanced assignment of record indices to (step, shard) slots.

    Layout: step-major, then shard, then chunk —

        global_idx = start + step*(n_shards*chunk) + shard*chunk + c

    so each shard reads a *contiguous* run of ``chunk_records`` per step
    (the HDFS-block locality analogue) while the set of records committed
    after k steps is the global prefix [start, start + k*n_shards*chunk).
    A single integer cursor therefore fully describes progress — that is
    what makes checkpoint/restart and elastic replanning exact.

    Every shard processes the same number of slots per step (SPMD
    requirement); slots beyond ``stop`` are padding, masked via step_mask.
    """

    start: int                # first record covered by this plan
    stop: int                 # one past the last record
    n_shards: int
    chunk_records: int        # records per shard per step

    @property
    def n_live(self) -> int:
        return max(self.stop - self.start, 0)

    @property
    def records_per_step(self) -> int:
        return self.n_shards * self.chunk_records

    @property
    def n_steps(self) -> int:
        return -(-self.n_live // self.records_per_step)    # ceil

    def step_indices(self, step: int) -> np.ndarray:
        """Global record indices for one step, shape (n_shards, chunk)."""
        s = np.arange(self.n_shards)[:, None]
        c = np.arange(self.chunk_records)[None, :]
        return (self.start + step * self.records_per_step
                + s * self.chunk_records + c)

    def step_mask(self, step: int) -> np.ndarray:
        return self.step_indices(step) < self.stop

    def cursor_after(self, step: int) -> int:
        """Resume cursor after committing steps 0..step (inclusive)."""
        return min(self.start + (step + 1) * self.records_per_step,
                   self.stop)

    def committed_records(self, step: int) -> int:
        """Records covered by committed steps 0..step (inclusive) —
        for this interleaved layout, exactly the cursor prefix."""
        if step < 0:
            return 0
        return self.cursor_after(step) - self.start

    def record_order(self) -> np.ndarray:
        """Record ids in step-delivery order.  The interleaved layout
        delivers ascending global prefixes, so this is the identity —
        the contract :class:`repro_torch.distributed.partition.PartitionPlan`
        overrides (its shards advance in parallel, so the event-log
        append order interleaves the spans)."""
        return np.arange(self.start, self.stop, dtype=np.int64)


def plan(manifest: DatasetManifest, n_shards: int, chunk_records: int,
         start: int = 0) -> ShardPlan:
    return ShardPlan(start=start, stop=manifest.n_records,
                     n_shards=n_shards, chunk_records=chunk_records)


def replan(old: ShardPlan, committed_steps: int, new_n_shards: int) -> ShardPlan:
    """Elastic re-shard: cover exactly the records the old plan had not
    committed, balanced over ``new_n_shards`` workers.

    NOTE committed-step accounting is per-step-across-all-shards, i.e. the
    pipeline commits a step only once every shard finished it (a barrier the
    runtime already has at the device step).  Uncommitted partial work is
    simply recomputed — idempotent because the manifest is deterministic.
    """
    cursor = old.cursor_after(committed_steps - 1) if committed_steps > 0 \
        else old.start
    return ShardPlan(start=cursor, stop=old.stop, n_shards=new_n_shards,
                     chunk_records=old.chunk_records)
