"""Resumable feature store for pipeline outputs (fault-tolerance layer).

Results live in memory-mapped .npy files — one ``(n_records, *shape)``
array per feature, laid out from whatever shapes the feature registry
declares (``open_arrays``), so new workloads need no store changes.
Progress is a cursor JSON committed with write-to-temp + atomic rename,
so a crash at any point leaves either the old or the new cursor — never
a torn state.  On resume, the committed cursor tells the driver which
plan steps to skip; any step that was in flight when the job died is
recomputed (idempotent: the manifest is deterministic and writes are
per-record).  The reduction carry (epoch aggregates AND partially
filled window states) rides each commit as a binary ``agg-<cursor>.npz``
sidecar referenced from the cursor, so aggregates and windowed products
also survive the crash — bitwise.
"""
from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

from repro_torch.faults.errors import StoreIntegrityError

from .manifest import DatasetManifest, ShardPlan
from .params import DepamParams
from .tol import band_matrix as make_band_matrix


class FeatureStore:
    """``faults`` (a :class:`repro.faults.plan.FaultPlan`, tests only)
    arms the two crash points of the commit protocol —
    ``crash_after_sidecar`` / ``crash_before_commit`` — simulating
    process death at the exact instants the write-fsync-rename dance is
    designed to survive.  None (the default) compiles to two attribute
    checks per commit: the production path carries no injection code.
    """

    def __init__(self, root: str, faults=None):
        self.root = root
        self.faults = faults
        os.makedirs(root, exist_ok=True)
        self._arrays: dict[str, np.memmap] | None = None
        self._events: dict[str, dict] | None = None
        self._instrument: dict | None = None

    # -- instrument provenance ----------------------------------------
    def set_instrument(self, instrument) -> None:
        """Pin the calibration chain this store's values are produced
        under; it commits with every cursor.  A store with committed
        state under a DIFFERENT calibration refuses loudly — resuming
        would mix two pressure scales in one output, which no readback
        could ever detect.

        Accepts an :class:`repro.meta.instrument.Instrument`, a
        state dict, or None (uncalibrated).
        """
        state = None if instrument is None \
            else instrument.to_state() if hasattr(instrument, "to_state") \
            else dict(instrument)
        prev = self.load_cursor()
        if prev is not None and prev.get("instrument") != state:
            raise StoreIntegrityError(
                f"store {self.root!r} was committed under instrument "
                f"{prev.get('instrument')!r} but this run presents "
                f"{state!r}: a resumed job must use the exact "
                f"calibration of its committed records — fix the "
                f"instrument or start a fresh store directory",
                path=self._cursor_path())
        self._instrument = state

    def load_instrument(self) -> dict | None:
        """The committed instrument state dict, or None."""
        st = self.load_cursor()
        return None if st is None else st.get("instrument")

    # -- result arrays ------------------------------------------------
    def _array_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.npy")

    def array_exists(self, name: str) -> bool:
        return os.path.exists(self._array_path(name))

    def open_arrays(self, shapes: dict[str, tuple[int, ...]], *,
                    extend: bool = False) -> dict[str, np.memmap]:
        """Open (or create) one float32 memmap per named feature.

        ``shapes`` are FULL array shapes including the leading dim
        (n_records for per-record features, n_windows for windowed
        reduction outputs).  Reopening an existing store validates the
        layout, so a feature-set or parameter change on resume fails
        loudly instead of writing through a stale layout.

        ``extend=True`` opens the named arrays *in addition to* whatever
        this instance already holds (the windowed-output layout arrives
        in a second call after the per-record one): overlapping names
        are shape-validated against the open memmaps, new names are
        opened/created, and only the requested names are returned.  The
        default (``extend=False``) keeps the strict contract: the
        requested layout must equal the cached one exactly.
        """
        want = {k: tuple(s) for k, s in shapes.items()}
        if self._arrays is not None and not extend:
            cached = {k: tuple(a.shape) for k, a in self._arrays.items()}
            if cached != want:
                raise ValueError(
                    f"store already opened with a different layout: "
                    f"open {cached}, requested {want}")
            return self._arrays
        opened = self._arrays if self._arrays is not None else {}
        out = {}
        for name, shape in want.items():
            if name in opened:
                if tuple(opened[name].shape) != shape:
                    raise ValueError(
                        f"store already opened with a different layout "
                        f"for {name!r}: open {tuple(opened[name].shape)},"
                        f" requested {shape}")
                out[name] = opened[name]
                continue
            path = self._array_path(name)
            if os.path.exists(path):
                mm = np.lib.format.open_memmap(path, mode="r+")
                if tuple(mm.shape) != shape:
                    raise ValueError(
                        f"store layout mismatch for {name!r}: on disk "
                        f"{tuple(mm.shape)}, requested {shape} "
                        f"(did the feature set or params change?)")
                if mm.dtype != np.float32:
                    raise ValueError(
                        f"store dtype mismatch for {name!r}: on disk "
                        f"{mm.dtype}, expected float32 (stale array "
                        f"from another tool? use a fresh store dir)")
                out[name] = mm
            else:
                out[name] = np.lib.format.open_memmap(
                    path, mode="w+", dtype=np.float32, shape=shape)
        self._arrays = {**opened, **out}
        return out

    def arrays(self, m: DatasetManifest, p: DepamParams, with_tol: bool):
        """Legacy layout (welch/spl[/tol]) — thin open_arrays wrapper."""
        spec = {"welch": (m.n_records, p.n_bins),
                "spl": (m.n_records,)}
        if with_tol:
            spec["tol"] = (m.n_records, make_band_matrix(p).shape[1])
        return self.open_arrays(spec)

    # -- event logs ---------------------------------------------------
    # A ragged feature stores two files: ``<name>.counts.npy`` — an
    # (n_records,) int32 memmap of TRUE per-record event counts — and
    # ``<name>.events.bin`` — the kept rows as raw float32, append-only
    # in record order.  The durable length of the bin is NOT its file
    # size but the per-log row cursor committed in cursor.json
    # ("events": {name: n_rows}); open_events truncates the bin back to
    # that cursor, so rows appended (or half-appended) by a crashed run
    # vanish and a resumed job re-appends them exactly once.

    def _event_counts_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.counts.npy")

    def _event_rows_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.events.bin")

    def event_log_exists(self, name: str) -> bool:
        return os.path.exists(self._event_rows_path(name))

    def open_events(self, layouts: dict[str, tuple[int, int]]) -> None:
        """Open (or create) the event logs: ``{name: (n_records,
        n_cols)}``.  Truncates each rows file to its committed length
        (see above) — call before writing, never after."""
        st = self.load_cursor() or {}
        committed = st.get("events", {})
        committed_crc = st.get("events_crc", {})
        self._events = {}
        for name, (n_records, n_cols) in layouts.items():
            cpath = self._event_counts_path(name)
            if os.path.exists(cpath):
                counts = np.lib.format.open_memmap(cpath, mode="r+")
                if tuple(counts.shape) != (n_records,) \
                        or counts.dtype != np.int32:
                    raise ValueError(
                        f"event-log layout mismatch for {name!r}: on "
                        f"disk {counts.dtype}{tuple(counts.shape)}, "
                        f"requested int32({n_records},)")
            else:
                counts = np.lib.format.open_memmap(
                    cpath, mode="w+", dtype=np.int32, shape=(n_records,))
            rows_committed = int(committed.get(name, 0))
            rpath = self._event_rows_path(name)
            if not os.path.exists(rpath):
                open(rpath, "xb").close()
            f = open(rpath, "r+b")
            want = rows_committed * n_cols * 4
            # crash debris beyond the committed cursor is truncated away
            # (the repair case: a half-appended step vanishes and the
            # resumed job re-appends it exactly once)...
            f.truncate(want)
            f.seek(0)
            prefix = f.read(want)
            crc = zlib.crc32(prefix)
            expect = committed_crc.get(name)
            # ...but damage WITHIN the committed prefix — a short file
            # silently zero-extended by the truncate above, or flipped
            # bits — is unrepairable and must never resume silently
            if expect is not None and crc != expect:
                f.close()
                raise StoreIntegrityError(
                    f"event log {rpath!r} failed CRC32 over its "
                    f"committed {rows_committed} rows (expected "
                    f"{expect:#010x}, got {crc:#010x}): the committed "
                    f"prefix is torn or corrupt; the store cannot "
                    f"resume from it — restore the file or start a "
                    f"fresh store directory", path=rpath)
            self._events[name] = {"counts": counts, "file": f,
                                  "n_cols": n_cols,
                                  "rows": rows_committed, "crc": crc}

    def append_events(self, name: str, indices: np.ndarray,
                      counts: np.ndarray, rows: np.ndarray) -> None:
        """One step's slice: TRUE counts for ``indices`` plus the kept
        rows, appended at the current end of the log."""
        ev = self._events[name]
        ev["counts"][indices] = counts
        data = np.ascontiguousarray(rows, np.float32).tobytes()
        ev["file"].write(data)
        ev["crc"] = zlib.crc32(data, ev["crc"])
        ev["rows"] += len(rows)

    def read_events(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(counts, rows) of an OPEN log — includes appended rows that
        are not yet covered by a commit (the engine only reads after
        the final commit)."""
        ev = self._events[name]
        ev["file"].flush()
        with open(self._event_rows_path(name), "rb") as f:
            buf = f.read(ev["rows"] * ev["n_cols"] * 4)
        rows = np.frombuffer(buf, np.float32).reshape(-1, ev["n_cols"])
        return np.asarray(ev["counts"]).copy(), rows.copy()

    def load_events(self, name: str,
                    n_cols: int) -> tuple[np.ndarray, np.ndarray]:
        """Read a COMMITTED log from disk (no open_events needed):
        only the rows the cursor covers, which is all a crashed run
        durably produced.  Rows come back in APPEND order — ascending
        record order for single-shard plans; partitioned plans
        interleave their spans, so permute with
        ``repro.api.sinks.reorder_event_rows`` and the stored plan's
        ``record_order()`` (``load_plan`` +
        ``repro_torch.distributed.partition.plan_from_state``) when record
        order matters."""
        st = self.load_cursor() or {}
        n_rows = int(st.get("events", {}).get(name, 0))
        counts = np.asarray(np.lib.format.open_memmap(
            self._event_counts_path(name), mode="r")).copy()
        with open(self._event_rows_path(name), "rb") as f:
            buf = f.read(n_rows * n_cols * 4)
        return counts, np.frombuffer(
            buf, np.float32).reshape(-1, n_cols).copy()

    def close_events(self) -> None:
        if self._events:
            for ev in self._events.values():
                ev["file"].close()
        self._events = None

    # -- cursor -------------------------------------------------------
    def _cursor_path(self) -> str:
        return os.path.join(self.root, "cursor.json")

    def commit_state(self, plan: ShardPlan, step: int,
                     agg: dict[str, np.ndarray] | None,
                     live: float) -> None:
        """Atomically commit progress through ``step`` (inclusive) plus
        the reduction carry state (epoch aggregates AND multi-window
        partials).

        The carry can be large (a multi-window SPD histogram is
        ``n_windows x n_bins x n_db``), so it is persisted as a binary
        ``.npz`` sidecar, not JSON text.  The sidecar is named by the
        cursor it belongs to and written+fsynced BEFORE the cursor
        rename, so the atomically-committed ``cursor.json`` always
        references a matching, fully-durable state file — a crash
        between the two leaves an orphan sidecar (garbage-collected on
        the next commit), never a torn pair.
        """
        if self._arrays:
            for a in self._arrays.values():
                a.flush()
        cursor = plan.cursor_after(step)
        plan_state = {"start": plan.start, "stop": plan.stop,
                      "n_shards": plan.n_shards,
                      "chunk_records": plan.chunk_records}
        offsets = getattr(plan, "offsets", None)
        if offsets is not None:
            # partitioned plans persist their span cut points, so a
            # resume rebuilds the exact same shard layout regardless of
            # the device count it runs on
            plan_state["offsets"] = [int(o) for o in offsets]
        # the cursor is a LOW WATERMARK under partitioned plans (the
        # smallest uncommitted record); the explicit step count and the
        # per-shard cursors carry the rest of the progress state
        state = {"cursor": cursor, "step": int(step),
                 "plan": plan_state, "live": live}
        if self._instrument is not None:
            state["instrument"] = self._instrument
        else:
            # a commit from a path that never set the instrument must
            # not erase committed provenance (set_instrument already
            # refused any actual mismatch)
            prev_inst = self.load_instrument()
            if prev_inst is not None:
                state["instrument"] = prev_inst
        shard_cursors = getattr(plan, "shard_cursors", None)
        if shard_cursors is not None:
            state["shard_cursors"] = [int(c) for c in shard_cursors(step)]
        if self._events:
            # event rows become durable BEFORE the cursor that covers
            # them is renamed in; the recorded row counts are exactly
            # what append_events has applied so far (FIFO sinks
            # guarantee that is the rows of steps <= this one)
            for ev in self._events.values():
                ev["counts"].flush()
                ev["file"].flush()
                os.fsync(ev["file"].fileno())
            state["events"] = {name: ev["rows"]
                               for name, ev in self._events.items()}
            # running CRC32 of each log's committed prefix; open_events
            # re-verifies it, so a torn tail *within* the committed
            # range trips loudly (a tail BEYOND the cursor is normal
            # crash debris — truncated away on open, the repair case)
            state["events_crc"] = {name: ev["crc"]
                                   for name, ev in self._events.items()}
        else:
            # a commit from a job without open logs must not orphan an
            # existing log's cursor — later opens would truncate to 0
            # under counts that still claim events
            prev = self.load_cursor()
            if prev and "events" in prev:
                state["events"] = prev["events"]
                if "events_crc" in prev:
                    state["events_crc"] = prev["events_crc"]
        if agg:
            # serialize in memory first so the CRC32 committed in the
            # cursor covers exactly the bytes renamed in — load_agg
            # verifies it before deserializing, so a torn or bit-rotted
            # sidecar fails loudly by name instead of resuming garbage
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v) for k, v in agg.items()})
            payload = buf.getvalue()
            fname = f"agg-{cursor}.npz"
            tmp = os.path.join(self.root, fname + ".tmp")
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.root, fname))
            state["agg_file"] = fname
            state["agg_crc"] = zlib.crc32(payload)
        if self.faults is not None:
            # the sidecar is durable, the cursor still names its
            # predecessor: resume must use the OLD pair (the new
            # sidecar is an orphan, GC'd by the next commit)
            self.faults.crash("crash_after_sidecar")
        tmp = self._cursor_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        if self.faults is not None:
            # cursor tmp is durable but not renamed in: resume must
            # ignore it entirely
            self.faults.crash("crash_before_commit")
        os.replace(tmp, self._cursor_path())      # atomic commit
        for name in os.listdir(self.root):        # GC stale sidecars
            if name.startswith("agg-") and name != state.get("agg_file") \
                    and (name.endswith(".npz") or name.endswith(".tmp")):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass

    def commit(self, plan: ShardPlan, step: int, welch_sum: np.ndarray,
               live: float) -> None:
        """Legacy signature: the welch partial sum + live count."""
        self.commit_state(plan, step, {"welch": welch_sum}, live)

    def load_cursor(self) -> dict | None:
        try:
            with open(self._cursor_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def load_agg(self) -> tuple[dict[str, np.ndarray], float] | None:
        """Committed reduction-carry state as (partials, live), or None.

        Reads the binary ``agg_file`` sidecar the cursor references;
        the inline JSON ``agg`` mapping of older cursors is still
        readable (the engine refuses to RESUME pre-windowed-layout
        state — its keys no longer match — but the data stays
        inspectable).
        """
        st = self.load_cursor()
        if st is None:
            return None
        if "agg_file" in st:
            path = os.path.join(self.root, st["agg_file"])
            with open(path, "rb") as f:
                payload = f.read()
            if "agg_crc" in st:
                crc = zlib.crc32(payload)
                if crc != int(st["agg_crc"]):
                    raise StoreIntegrityError(
                        f"aggregate sidecar {path!r} failed CRC32 "
                        f"(cursor expects {int(st['agg_crc']):#010x}, "
                        f"file has {crc:#010x}): the committed carry "
                        f"state is torn or corrupt; resuming it would "
                        f"silently poison every later aggregate — "
                        f"restore the file or start a fresh store "
                        f"directory", path=path)
            with np.load(io.BytesIO(payload)) as z:
                agg = {k: np.asarray(z[k], np.float64) for k in z.files}
        elif "agg" in st:
            agg = {k: np.asarray(v, np.float64)
                   for k, v in st["agg"].items()}
        else:
            agg = {}
        return agg, float(st.get("live", 0.0))

    def load_plan(self) -> dict | None:
        """The plan geometry the committed cursor was written under, or
        None — what the engine adopts on resume (re-partitioning a job
        checkpointed at a different device count)."""
        st = self.load_cursor()
        return None if st is None else st.get("plan")

    def committed_steps(self, plan: ShardPlan) -> int:
        """How many steps of ``plan`` are already fully committed.

        Cursors written by this release record the committed step
        explicitly (the watermark cursor of a partitioned plan cannot
        recover it when shard spans are heterogeneous); legacy cursors
        fall back to the prefix arithmetic of the interleaved layout.
        """
        st = self.load_cursor()
        if st is None:
            return 0
        if "step" in st:
            return max(0, int(st["step"]) + 1)
        done = st["cursor"] - plan.start
        return max(0, min(done // plan.records_per_step, plan.n_steps))
