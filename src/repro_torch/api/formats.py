"""Interoperable labeled sinks: Zarr and NetCDF outputs.

The memmap :class:`~repro_torch.api.sinks.StoreSink` is the durability
workhorse, but its arrays are anonymous — record-indexed float32 with
no time axis, no frequency coordinate, no instrument provenance.  The
two sinks here emit what the PAM community actually consumes
(echopype / pypam style): CF-ish labeled datasets with

  * a ``time`` coordinate per record — UTC epoch seconds
    (``seconds since 1970-01-01T00:00:00Z``, so xarray decodes
    datetime64) when the manifest carries filename timestamps, relative
    seconds otherwise;
  * a ``frequency`` coordinate (``arange(n_bins) * df`` Hz);
  * per-window time coordinates for every windowed reduction output
    (LTSA panels, SPD histograms), derived from the engine's window
    edges via ``manifest.record_times``;
  * ragged event tables flattened over an event dimension with absolute
    onset timestamps;
  * the :class:`~repro_torch.meta.Instrument` calibration chain as global
    attrs.

**ZarrSink** writes a zarr-v2 directory natively — plain JSON metadata
plus one raw uncompressed file per chunk, the spec's lowest common
denominator — so it needs no ``zarr`` package at write time while any
zarr/xarray reader opens the result.  It is fully *resumable*: all
cursor/aggregate/event durability is delegated to an embedded
:class:`~repro_torch.core.store.FeatureStore` (``<path>/.depam_state``) and
the dense features land in time-chunked zarr files written with the
same write-fsync-rename discipline as the store's own commit protocol.
Chunk writes are atomic (tmp + rename), so a crash never tears a
chunk; on resume, chunk files lying entirely beyond the committed
cursor are deleted (the analogue of the event log's
truncate-to-cursor) and damaged files inside the committed region
refuse loudly.

**NetCDFSink** composes the plain StoreSink for execution and
durability (state lives at ``<path>.state``) and materializes one
labeled ``.nc`` file atomically when the job completes — through
``netCDF4`` when importable, else scipy's NetCDF-3 writer (scipy is
already a hard dependency).  Its values are bitwise-identical to the
FeatureStore run by construction: they *are* the store's memmaps.

Neither sink imports zarr/netCDF4/xarray at module import time; the
repo stays importable (and tier-1 green) without them.  The optional
packages only add readback convenience — the tests exercising them use
``pytest.importorskip``.
"""
from __future__ import annotations

import itertools
import json
import os

import numpy as np

from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore
from repro_torch.faults.errors import StoreIntegrityError
from repro_torch.meta.instrument import Instrument
from repro_torch.meta.timestamps import format_utc

from .sinks import Sink, StoreSink

_EPOCH_UNITS = "seconds since 1970-01-01T00:00:00Z"


# ---------------------------------------------------------------------
# minimal zarr-v2 directory writer/reader (pure numpy + json)
# ---------------------------------------------------------------------

def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _dtype_str(dt: np.dtype) -> str:
    return np.dtype(dt).str     # "<f4", "<f8", "<i4", ... (zarr v2)


def _zarr_init_array(adir: str, shape: tuple[int, ...],
                     chunks: tuple[int, ...], dtype, dims: list[str],
                     attrs: dict | None = None,
                     fill_value: float = 0.0) -> None:
    """Create (or re-validate) one zarr array directory.

    No compressor, no filters, C order: a chunk file is exactly the raw
    little-endian bytes of its (padded-to-chunk-shape) block, which is
    what makes readback — and the bitwise store-equivalence contract —
    trivial.
    """
    os.makedirs(adir, exist_ok=True)
    meta = {"zarr_format": 2, "shape": list(shape),
            "chunks": list(chunks), "dtype": _dtype_str(dtype),
            "compressor": None, "fill_value": fill_value,
            "order": "C", "filters": None}
    mpath = os.path.join(adir, ".zarray")
    if os.path.exists(mpath):
        with open(mpath) as f:
            have = json.load(f)
        if have != meta:
            raise ValueError(
                f"zarr array {adir!r} exists with different metadata "
                f"(on disk {have}, requested {meta}) — the layout, "
                f"chunking or dtype changed since the store was "
                f"written; use a fresh output path")
        return
    _write_json(mpath, meta)
    zattrs = {"_ARRAY_DIMENSIONS": list(dims)}
    zattrs.update(attrs or {})
    _write_json(os.path.join(adir, ".zattrs"), zattrs)


def _chunk_key(cidx: tuple[int, ...]) -> str:
    return ".".join(str(i) for i in cidx)


def _write_chunk(adir: str, cidx: tuple[int, ...],
                 block: np.ndarray) -> None:
    """One chunk, durably: tmp write + fsync + atomic rename, the same
    discipline as the store's cursor — so the commit that follows never
    covers bytes that could vanish, and a crash mid-write leaves only
    ``.tmp`` debris (swept on resume), never a torn chunk."""
    path = os.path.join(adir, _chunk_key(cidx))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(np.ascontiguousarray(block).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_chunk(adir: str, cidx: tuple[int, ...],
                chunks: tuple[int, ...], dtype,
                fill_value: float) -> np.ndarray:
    """One chunk as a writable array; missing file = fill value (the
    zarr contract for never-written chunks)."""
    path = os.path.join(adir, _chunk_key(cidx))
    try:
        buf = np.fromfile(path, dtype=dtype)
    except FileNotFoundError:
        return np.full(chunks, fill_value, dtype)
    want = int(np.prod(chunks))
    if buf.size != want:
        raise StoreIntegrityError(
            f"zarr chunk {path!r} holds {buf.size} elements, expected "
            f"{want}: the file is torn or was written by a different "
            f"layout; the store cannot resume from it — restore the "
            f"file or start a fresh output directory", path=path)
    return buf.reshape(chunks).copy()


def _write_whole_array(adir: str, data: np.ndarray, dims: list[str],
                       attrs: dict | None = None,
                       chunk0: int | None = None,
                       fill_value: float = 0.0) -> None:
    """Create an array and write all of it (coords, event tables)."""
    data = np.ascontiguousarray(data)
    c0 = data.shape[0] if chunk0 is None else min(chunk0, data.shape[0])
    chunks = (max(c0, 1),) + data.shape[1:]
    _zarr_init_array(adir, data.shape, chunks, data.dtype, dims, attrs,
                     fill_value)
    for ci in range(max(-(-data.shape[0] // chunks[0]), 1)):
        block = data[ci * chunks[0]:(ci + 1) * chunks[0]]
        if block.shape[0] < chunks[0]:       # pad the edge chunk
            pad = np.full(chunks, fill_value, data.dtype)
            pad[:block.shape[0]] = block
            block = pad
        _write_chunk(adir, (ci,) + (0,) * (data.ndim - 1), block)


def read_zarr_array(adir: str) -> np.ndarray:
    """Read one of our zarr arrays back into numpy (no zarr needed)."""
    with open(os.path.join(adir, ".zarray")) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    fill = meta["fill_value"]
    out = np.full(shape, fill, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for cidx in itertools.product(*grid):
        path = os.path.join(adir, _chunk_key(cidx))
        if not os.path.exists(path):
            continue
        block = _read_chunk(adir, cidx, chunks, dtype, fill)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(cidx, chunks, shape))
        out[sel] = block[tuple(slice(0, sl.stop - sl.start)
                               for sl in sel)]
    return out


# ---------------------------------------------------------------------
# shared labeling helpers
# ---------------------------------------------------------------------

def _time_attrs(m: DatasetManifest) -> dict:
    if m.has_timestamps:
        return {"units": _EPOCH_UNITS, "calendar": "proleptic_gregorian",
                "standard_name": "time", "long_name": "record start time"}
    return {"units": "s", "long_name": "seconds since start of dataset"}


def _global_attrs(m: DatasetManifest, p: DepamParams,
                  instrument: Instrument | None) -> dict:
    attrs = {"Conventions": "CF-1.8", "source": "DEPAM reproduction",
             "sampling_rate_hz": float(m.fs),
             "record_size_samples": int(m.record_size),
             "nfft": int(p.nfft)}
    if instrument is not None:
        attrs.update(instrument.as_attrs())
    if m.has_timestamps:
        win = m.utc_window()
        if win is not None:
            attrs["time_coverage_start"] = format_utc(win[0])
            attrs["time_coverage_end"] = format_utc(win[1])
            attrs["time_coverage_gap_seconds"] = float(m.gap_seconds())
    return attrs


def _feature_dims(name: str, shape: tuple[int, ...],
                  p: DepamParams) -> list[str]:
    """time + trailing dims; a trailing axis of n_bins is ``frequency``
    (shares the coord), anything else gets a private dim name."""
    dims = ["time"]
    for ax, n in enumerate(shape):
        dims.append("frequency" if n == p.n_bins else f"{name}_d{ax + 1}")
    return dims


def _event_table(name: str, log, m: DatasetManifest,
                 p: DepamParams) -> dict[str, np.ndarray]:
    """Flatten one EventLog into labeled per-column 1-D arrays.

    ``<name>_record`` are the owning record ids, ``<name>_time`` the
    absolute event times — record start plus ``onset * hop / fs`` when
    the log carries an ``onset`` column (detected events), the record
    start itself otherwise (per-record metrics).
    """
    kept = np.minimum(log.counts, log.capacity).astype(np.int64)
    rec = np.repeat(np.arange(len(log.counts), dtype=np.int64), kept)
    out = {f"{name}_record": rec.astype(np.int32)}
    for ci, col in enumerate(log.columns):
        out[f"{name}_{col}"] = log.rows[:, ci]
    times = m.record_times(rec) if rec.size \
        else np.zeros(0, np.float64)
    if "onset" in log.columns:
        onset = log.rows[:, log.columns.index("onset")].astype(np.float64)
        times = times + onset * (p.hop / m.fs)
    out[f"{name}_time"] = times
    return out


# ---------------------------------------------------------------------
# ZarrSink
# ---------------------------------------------------------------------

class ZarrSink(Sink):
    """Resumable sink writing a labeled zarr-v2 directory store.

    Layout under ``path``: one array directory per dense feature
    (``(time[, frequency...])``, float32, chunked ``chunk_records``
    along time), per windowed output (its own ``time_<name>`` axis),
    and per event column; coordinate arrays ``time``/``frequency``;
    ``.depam_state/`` holds the embedded FeatureStore that carries the
    cursor, aggregate sidecars, event logs and instrument provenance —
    exactly the commit protocol (and crash semantics) of a StoreSink.

    ``chunk_records`` is the object-storage knob: records per chunk
    along the time axis (all trailing axes are one chunk).
    """

    resumable = True

    def __init__(self, path: str, chunk_records: int = 256,
                 faults=None):
        if chunk_records < 1:
            raise ValueError(
                f"chunk_records must be >= 1, got {chunk_records}")
        self.path = path
        self.chunk_records = int(chunk_records)
        os.makedirs(path, exist_ok=True)
        self.store = FeatureStore(os.path.join(path, ".depam_state"),
                                  faults=faults)
        self._instrument: Instrument | None = None
        self._m: DatasetManifest | None = None
        self._p: DepamParams | None = None
        self._plan: ShardPlan | None = None
        self._shapes: dict[str, tuple[int, ...]] = {}
        self._wshapes: dict[str, tuple[int, ...]] = {}
        self._edges: dict[str, np.ndarray] = {}
        self._event_meta: dict[str, tuple[tuple[str, ...], int]] = {}

    # -- identity / provenance ---------------------------------------
    def set_instrument(self, instrument):
        self.store.set_instrument(instrument)
        self._instrument = instrument

    def describe(self):
        d = {"format": "zarr", "path": self.path}
        st = self.store.load_cursor()
        if st is not None:
            d["committed_records"] = int(st["cursor"])
            if self._m is not None and self._m.has_timestamps \
                    and st["cursor"] > 0:
                # high-watermark: the END of the last committed record
                t = self._m.record_times(int(st["cursor"]) - 1)[0] \
                    + self._m.record_size / self._m.fs
                d["committed_utc"] = format_utc(t)
        return d

    # -- lifecycle -----------------------------------------------------
    def _adir(self, name: str) -> str:
        return os.path.join(self.path, name)

    def open(self, m, p, shapes, plan):
        self._m, self._p, self._plan = m, p, plan
        self._shapes = {k: tuple(v) for k, v in shapes.items()}
        committed = self.store.committed_steps(plan)
        if committed > 0:
            missing = sorted(
                n for n in shapes
                if not os.path.exists(os.path.join(self._adir(n),
                                                   ".zarray")))
            if missing:
                raise ValueError(
                    f"cannot resume: features {missing} have no data "
                    f"for the {committed} already-committed steps "
                    f"(added after the store was written?); use a fresh "
                    f"output directory or drop them from the job")
        cursor = 0
        st = self.store.load_cursor()
        if st is not None:
            cursor = int(st["cursor"])
        _write_json(os.path.join(self.path, ".zgroup"),
                    {"zarr_format": 2})
        _write_json(os.path.join(self.path, ".zattrs"),
                    _global_attrs(m, p, self._instrument))
        for name, shape in self._shapes.items():
            full = (m.n_records,) + shape
            chunks = (min(self.chunk_records, m.n_records),) + shape
            _zarr_init_array(self._adir(name), full, chunks, np.float32,
                             _feature_dims(name, shape, p))
            self._sweep_debris(self._adir(name), chunks, cursor)
        # coordinates (idempotent rewrites of derived data)
        times = m.record_times(np.arange(m.n_records)) if m.n_records \
            else np.zeros(0, np.float64)
        _write_whole_array(self._adir("time"), times, ["time"],
                           _time_attrs(m), chunk0=None)
        _write_whole_array(
            self._adir("frequency"),
            np.arange(p.n_bins, dtype=np.float64) * p.df, ["frequency"],
            {"units": "Hz", "standard_name": "sound_frequency"})

    def _sweep_debris(self, adir: str, chunks: tuple[int, ...],
                      cursor: int) -> None:
        """Resume hygiene for one time-chunked array: drop ``.tmp``
        leftovers and chunk files lying entirely beyond the committed
        cursor — the chunk-granular analogue of the event log's
        truncate-to-committed.  (A chunk straddling the cursor keeps
        its committed prefix; its tail is recomputed and overwritten.)
        Torn files inside the committed region fail loudly at read
        time via the size check in ``_read_chunk``."""
        first_uncommitted = -(-cursor // chunks[0])  # ceil
        for fname in os.listdir(adir):
            fpath = os.path.join(adir, fname)
            if fname.endswith(".tmp"):
                os.remove(fpath)
                continue
            if fname.startswith("."):
                continue
            lead = fname.split(".", 1)[0]
            if lead.isdigit() and int(lead) >= first_uncommitted:
                os.remove(fpath)

    def open_windows(self, shapes):
        self._wshapes = {k: tuple(v) for k, v in shapes.items()}
        for name, full in self._wshapes.items():
            chunks = (min(self.chunk_records, max(full[0], 1)),) \
                + full[1:]
            dims = [f"time_{name}"] + [
                "frequency" if n == self._p.n_bins else f"{name}_d{ax+1}"
                for ax, n in enumerate(full[1:])]
            _zarr_init_array(self._adir(name), full, chunks, np.float32,
                             dims)

    def open_window_edges(self, edges):
        self._edges = {k: np.asarray(v) for k, v in edges.items()}
        for name, e in self._edges.items():
            starts = self._m.record_times(e[:-1]) if len(e) > 1 \
                else np.zeros(0, np.float64)
            attrs = dict(_time_attrs(self._m))
            attrs["long_name"] = f"window start time of {name}"
            _write_whole_array(self._adir(f"time_{name}"), starts,
                               [f"time_{name}"], attrs)

    def open_events(self, layouts):
        committed = self.store.committed_steps(self._plan)
        if committed > 0:
            missing = sorted(n for n in layouts
                             if not self.store.event_log_exists(n))
            if missing:
                raise ValueError(
                    f"cannot resume: event logs {missing} have no data "
                    f"for the {committed} already-committed steps "
                    f"(added after the store was written?); use a fresh "
                    f"output directory or drop them from the job")
        self._event_meta = dict(layouts)
        self.store.open_events(
            {name: (self._m.n_records, len(cols))
             for name, (cols, _cap) in layouts.items()})

    # -- data plane ----------------------------------------------------
    def _rmw(self, adir: str, chunks: tuple[int, ...],
             indices: np.ndarray, values: np.ndarray) -> None:
        """Scatter rows into time-chunked files: group by chunk id,
        read-modify-write each touched chunk (atomic replace)."""
        cid = indices // chunks[0]
        order = np.argsort(cid, kind="stable")
        idx, vals, cid = indices[order], values[order], cid[order]
        brk = np.nonzero(np.diff(cid))[0] + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [len(idx)]])
        zeros = (0,) * (len(chunks) - 1)
        for s, e in zip(starts, ends):
            ci = int(cid[s])
            block = _read_chunk(adir, (ci,) + zeros, chunks,
                                np.float32, 0.0)
            block[idx[s:e] - ci * chunks[0]] = vals[s:e]
            _write_chunk(adir, (ci,) + zeros, block)

    def write(self, step, indices, values):
        idx = np.asarray(indices, np.int64)
        for name, vals in values.items():
            shape = self._shapes[name]
            chunks = (min(self.chunk_records, self._m.n_records),) + shape
            self._rmw(self._adir(name), chunks, idx,
                      np.asarray(vals, np.float32))

    def write_windows(self, name, start, values):
        vals = np.asarray(values, np.float32)
        full = self._wshapes[name]
        chunks = (min(self.chunk_records, max(full[0], 1),),) + full[1:]
        self._rmw(self._adir(name), chunks,
                  np.arange(start, start + len(vals), dtype=np.int64),
                  vals)

    def write_events(self, step, indices, values):
        for name, (counts, rows) in values.items():
            self.store.append_events(name, indices, counts, rows)

    def commit(self, plan, step, agg, live):
        # chunk files were fsynced before their rename, so the cursor
        # this commit renames in never covers non-durable feature bytes
        self.store.commit_state(plan, step, agg, live)

    # -- resume protocol (identical to StoreSink) ----------------------
    def resume_state(self):
        start = self.store.committed_steps(self._plan)
        if start <= 0:
            return 0, None
        return start, self.store.load_agg()

    def committed_steps(self, plan) -> int:
        return self.store.committed_steps(plan)

    def committed_plan(self) -> dict | None:
        return self.store.load_plan()

    # -- results -------------------------------------------------------
    def result(self):
        return {name: read_zarr_array(self._adir(name))
                for name in self._shapes}

    def event_result(self):
        from .sinks import EventLog, reorder_event_rows
        out = {}
        order = self._plan.record_order() if self._plan is not None \
            else None
        for name, (cols, cap) in self._event_meta.items():
            counts, rows = self.store.read_events(name)
            if order is not None:
                rows = reorder_event_rows(counts, rows, cap, order)
            out[name] = EventLog(counts=counts, rows=rows,
                                 columns=cols, capacity=cap)
        return out

    def _complete(self) -> bool:
        st = self.store.load_cursor()
        return st is not None and self._plan is not None \
            and int(st["cursor"]) >= self._plan.stop

    def _materialize_events(self):
        """Event logs -> labeled 1-D arrays over an ``event_<name>``
        dim, with absolute onset timestamps.  Runs only when the job's
        final commit landed (idempotent rewrites of committed data)."""
        for name, log in (self.event_result() or {}).items():
            _write_whole_array(
                self._adir(f"{name}_counts"),
                np.asarray(log.counts, np.int32), ["time"],
                {"long_name": f"true {name} count per record "
                              f"(> capacity flags overflow)",
                 "capacity": int(log.capacity)},
                chunk0=self.chunk_records)
            table = _event_table(name, log, self._m, self._p)
            for var, data in table.items():
                attrs = _time_attrs(self._m) \
                    if var == f"{name}_time" else None
                _write_whole_array(self._adir(var), data,
                                   [f"event_{name}"], attrs)

    def close(self):
        try:
            if self._event_meta and self._complete():
                self._materialize_events()
        finally:
            self.store.close_events()


# ---------------------------------------------------------------------
# NetCDFSink
# ---------------------------------------------------------------------

def _open_netcdf_writer(path: str):
    """(handle, backend) — netCDF4 when importable, else scipy NetCDF-3.

    Both expose ``createDimension`` / ``createVariable`` and attribute
    assignment by plain setattr, which is all the writer below uses.
    """
    try:
        import netCDF4                           # noqa: PLC0415
        return netCDF4.Dataset(path, "w"), "netCDF4"
    except ImportError:
        from scipy.io import netcdf_file         # noqa: PLC0415
        return netcdf_file(path, "w"), "scipy"


class NetCDFSink(Sink):
    """Labeled NetCDF output with StoreSink execution semantics.

    During the job this IS a :class:`~repro_torch.api.sinks.StoreSink` (state
    directory ``<path>.state`` — full resumability, bitwise-identical
    values); when the final step commits, ``close()`` materializes the
    labeled ``<path>`` file atomically (tmp + rename), so a half-built
    ``.nc`` is never observable.  A killed job leaves only the state
    directory; resuming finishes it and then writes the file.

    NetCDF has no incremental-chunk story comparable to zarr, which is
    exactly why the durable representation stays a FeatureStore until
    the end — the ``.nc`` is a *view* materialized from committed data.
    """

    resumable = True

    def __init__(self, path: str, faults=None):
        self.path = path
        self.inner = StoreSink(FeatureStore(path + ".state",
                                            faults=faults))
        self._instrument: Instrument | None = None
        self._m: DatasetManifest | None = None
        self._p: DepamParams | None = None
        self._edges: dict[str, np.ndarray] = {}
        self._wshapes: dict[str, tuple[int, ...]] = {}

    # delegation -------------------------------------------------------
    def set_instrument(self, instrument):
        self.inner.set_instrument(instrument)
        self._instrument = instrument

    def open(self, m, p, shapes, plan):
        self._m, self._p = m, p
        self.inner.open(m, p, shapes, plan)

    def open_windows(self, shapes):
        self._wshapes = {k: tuple(v) for k, v in shapes.items()}
        self.inner.open_windows(shapes)

    def open_window_edges(self, edges):
        self._edges = {k: np.asarray(v) for k, v in edges.items()}

    def open_events(self, layouts):
        self.inner.open_events(layouts)

    def write(self, step, indices, values):
        self.inner.write(step, indices, values)

    def write_windows(self, name, start, values):
        self.inner.write_windows(name, start, values)

    def write_events(self, step, indices, values):
        self.inner.write_events(step, indices, values)

    def commit(self, plan, step, agg, live):
        self.inner.commit(plan, step, agg, live)

    def resume_state(self):
        return self.inner.resume_state()

    def committed_steps(self, plan) -> int:
        return self.inner.committed_steps(plan)

    def committed_plan(self) -> dict | None:
        return self.inner.committed_plan()

    def result(self):
        return self.inner.result()

    def event_result(self):
        return self.inner.event_result()

    def describe(self):
        d = {"format": "netcdf", "path": self.path,
             "state": self.inner.store.root}
        st = self.inner.store.load_cursor()
        if st is not None:
            d["committed_records"] = int(st["cursor"])
            if self._m is not None and self._m.has_timestamps \
                    and st["cursor"] > 0:
                t = self._m.record_times(int(st["cursor"]) - 1)[0] \
                    + self._m.record_size / self._m.fs
                d["committed_utc"] = format_utc(t)
        d["materialized"] = os.path.exists(self.path)
        return d

    # materialization --------------------------------------------------
    def _complete(self) -> bool:
        st = self.inner.store.load_cursor()
        return st is not None and self.inner._plan is not None \
            and int(st["cursor"]) >= self.inner._plan.stop

    def _materialize(self):
        m, p = self._m, self._p
        tmp = self.path + ".tmp"
        nc, backend = _open_netcdf_writer(tmp)
        try:
            for k, v in _global_attrs(m, p, self._instrument).items():
                setattr(nc, k, v)
            nc.createDimension("time", m.n_records)
            nc.createDimension("frequency", p.n_bins)
            times = m.record_times(np.arange(m.n_records))
            tvar = nc.createVariable("time", np.dtype("f8"), ("time",))
            tvar[:] = times
            for k, v in _time_attrs(m).items():
                setattr(tvar, k, v)
            fvar = nc.createVariable("frequency", np.dtype("f8"),
                                     ("frequency",))
            fvar[:] = np.arange(p.n_bins, dtype=np.float64) * p.df
            fvar.units = "Hz"

            made_dims = {"time": m.n_records, "frequency": p.n_bins}

            def dim_for(label: str, n: int) -> str:
                if label in made_dims:
                    if made_dims[label] != n:
                        raise ValueError(
                            f"dimension {label!r} used at two sizes: "
                            f"{made_dims[label]} and {n}")
                    return label
                nc.createDimension(label, n)
                made_dims[label] = n
                return label

            arrays = self.inner.result() or {}
            for name, arr in arrays.items():
                dims = []
                for lab, n in zip(_feature_dims(name, arr.shape[1:], p),
                                  arr.shape):
                    dims.append(dim_for(lab, n))
                var = nc.createVariable(name, np.dtype("f4"),
                                        tuple(dims))
                var[:] = np.asarray(arr)

            for name, full in self._wshapes.items():
                arr = np.asarray(self.inner.window_arrays[name])
                dims = [dim_for(f"time_{name}", full[0])]
                for ax, n in enumerate(full[1:]):
                    dims.append(dim_for(
                        "frequency" if n == p.n_bins
                        else f"{name}_d{ax + 1}", n))
                var = nc.createVariable(name, np.dtype("f4"),
                                        tuple(dims))
                var[:] = arr
                e = self._edges.get(name)
                if e is not None and len(e) > 1:
                    wt = nc.createVariable(f"time_{name}",
                                           np.dtype("f8"),
                                           (f"time_{name}",))
                    wt[:] = m.record_times(e[:-1])
                    for k, v in _time_attrs(m).items():
                        setattr(wt, k, v)

            for name, log in (self.inner.event_result() or {}).items():
                cvar = nc.createVariable(f"{name}_counts",
                                         np.dtype("i4"), ("time",))
                cvar[:] = np.asarray(log.counts, np.int32)
                cvar.capacity = int(log.capacity)
                table = _event_table(name, log, m, p)
                n_ev = len(table[f"{name}_record"])
                if n_ev == 0:
                    # NetCDF-3 reads a 0-length dimension as the (one
                    # allowed) unlimited dim — skip empty tables rather
                    # than corrupt the file; the counts variable above
                    # still records "no events" faithfully
                    continue
                dim = dim_for(f"event_{name}", n_ev)
                for var_name, data in table.items():
                    dt = np.dtype("i4") if data.dtype.kind == "i" \
                        else np.dtype("f8") if data.dtype == np.float64 \
                        else np.dtype("f4")
                    v = nc.createVariable(var_name, dt, (dim,))
                    v[:] = data.astype(dt)
                    if var_name == f"{name}_time":
                        for k, val in _time_attrs(m).items():
                            setattr(v, k, val)
        finally:
            nc.close()
        os.replace(tmp, self.path)

    def close(self):
        try:
            if self._complete():
                self._materialize()
        finally:
            self.inner.close()
