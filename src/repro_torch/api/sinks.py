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
    boundaries, the trailing ones at job end).

Contract: ``open`` first, ``write(step=k)`` before ``commit(step=k)``,
steps ascending, and a commit makes every prior write durable.
``as_sink`` normalizes what users pass to ``job.to()``: ``None`` ->
in-memory arrays, a path string or ``FeatureStore`` -> the resumable
store, a callable -> streaming callback, a ``Sink`` -> itself.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore


class Sink:
    resumable: bool = False
    # Whether commit() needs the reduction carry.  The engine keeps the
    # carry on the device and copies it to the host only at the commit
    # boundaries of sinks that want it.
    wants_commit: bool = True

    def open(self, m: DatasetManifest, p: DepamParams,
             shapes: dict[str, tuple[int, ...]], plan: ShardPlan) -> None:
        pass

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

    def open(self, m, p, shapes, plan):
        self.arrays = {name: np.zeros((m.n_records,) + shape, np.float32)
                       for name, shape in shapes.items()}

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

    def open(self, m, p, shapes, plan):
        self._plan = plan
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
    streams finalized window rows as they close."""

    wants_commit = False

    def __init__(self, fn: Callable[[int, np.ndarray, dict], None],
                 on_windows: Callable[[str, int, np.ndarray],
                                      None] | None = None):
        self.fn = fn
        self.on_windows = on_windows
        # mid-job window flushes ride commit boundaries
        self.wants_commit = on_windows is not None

    def write(self, step, indices, values):
        self.fn(step, indices, values)

    def write_windows(self, name, start, values):
        if self.on_windows is not None:
            self.on_windows(name, start, values)


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
