"""The job engine: one step over all selected features per chunk.

Execution model (the paper's Fig 2.1): the *driver* is :func:`run_job`
— it owns the plan, runs one step per chunk, and commits progress
through the sink; the step runs every selected :class:`FeatureSpec`
against one shared :class:`FeatureContext`, so all features share the
Welch and per-frame PSDs and make a single pass over the data.

The reduction carry (epoch aggregates and multi-window LTSA/SPD/extrema
state) lives on the job's device across the whole job; a step writes, in
place, only the rows of the windows its records hit.  The whole carry is
copied to the host only at the commit boundaries of sinks that persist
it; a streaming sink that takes window flushes gets only the rows of the
windows each step closes.  Freshly closed windows are finalized and
flushed just before the commit that covers them.

Ragged (event) features return fixed-capacity slabs from the step; the
host compacts them to each record's kept rows and appends those to the
sink's event log before the step's commit.

Every reduction inside a step runs in a fixed order — a loop over the
step's few window ids, each a ``sum``/``amin``/``amax`` over the rows
that hit it — never a scatter with float atomics, so a resumed job is
bitwise-identical to an uninterrupted one and the int16 payload to the
float32 one.

The pipelined executor (:class:`ExecOptions`) changes only *when* the
host waits, never what the device computes:

  * host→device: each step's payload, decode scales and the carry's
    index (window row indices, hit window ids, live mask) are staged in
    pinned host buffers and copied with ``non_blocking`` on a dedicated
    copy stream; the compute stream
    (the current stream, on which every kernel launches) waits on that
    copy's CUDA event, so nothing in a step synchronizes the host;
  * device→host: at dispatch, the stored features, the ragged slabs
    and (for commit-consuming sinks) the carry as it stands after this
    step, or only the rows of the windows the step closes, start
    copying into fresh pinned buffers on a second stream; draining a
    step waits on that step's events only;
  * up to ``inflight`` steps stay dispatched before the oldest drains
    into the sink; ``finish`` drains the rest;
  * the job builder adds a :class:`~repro_torch.api.sources.
    PrefetchSource` (host reads ahead on a thread pool) and an
    :class:`~repro_torch.api.sinks.AsyncSink` (sink IO on a writer
    thread).

``ExecOptions()`` (the default) is the synchronous loop.  On the CPU
device the same queue runs over plain tensors: there are no streams or
pinned buffers to use.  Sync and async results are bitwise-equal
(``tests/test_torch_async.py``).

Under a mesh the step runs on several executors (see
:class:`JobStepper`); the step computes each logical shard in its own
calls and the carry merges per-shard partials in shard order, so every
executor count dividing the plan's shard count gives the same bits
(``tests/test_torch_partition.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import trace
from repro_torch.compat import carry_from_reference
from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams
from repro_torch.distributed import partition as partition_lib
from .features import (EPOCH_WINDOW, FeatureContext, FeatureSpec,
                       Reduction, StateField, Window)
from .graphs import StepGraphs
from .sinks import Sink
from .sources import Source, synth_record


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """Executor knobs; the default is the fully synchronous loop.

    ``inflight`` — device steps allowed in flight before the driver
    drains the oldest into the sink (0 = drain at once, i.e. sync).
    ``prefetch_depth`` — plan steps of host read-ahead; the job builder
    wraps host-fed sources in a ``PrefetchSource`` of this depth (0 =
    fetch inline).  ``queue_size`` — AsyncSink backpressure bound, in
    steps.  ``donate`` — PyTorch has no buffer donation; here it means
    that the engine drops its reference to a step's device payload right
    after dispatch, so the caching allocator can hand that memory to the
    next step's payload once the step's kernels are done with it (False
    keeps each payload alive until its step drains).
    """

    inflight: int = 0
    prefetch_depth: int = 0
    queue_size: int = 8
    donate: bool = True

    def __post_init__(self):
        if self.inflight < 0 or self.prefetch_depth < 0 \
                or self.queue_size < 1:
            raise ValueError(f"invalid ExecOptions: {self}")


def compile_step(specs: tuple[FeatureSpec, ...], m: DatasetManifest,
                 p: DepamParams, use_kernels: bool, device_synth: bool,
                 device: torch.device) -> Callable:
    """Build the per-chunk step for all selected features.

    The step takes ``payload`` — or ``(payload, scales)`` on the int16
    path — where payload is host int indices (device synthesis) or a
    device tensor of float32 waveforms or raw int16 PCM, all with
    ``(n_shards, chunk)`` leading layout; it dispatches on the payload's
    dtype.  ``graphs`` is the calling job's
    :class:`~repro_torch.api.graphs.StepGraphs` for this device (None:
    every chain eager).  It returns ``{feature: (n_shards, chunk,
    *shape)}`` (ragged: ``{"counts", "rows"}``) over every slot, padding
    included: the reductions mask padding themselves, and the host drops
    padding rows before any sink sees them.  A value that is a graph's
    static output is cloned where it must outlive the graph's next
    replay: a stored feature (the host copies it back later), or any
    value of a step of several shard rows.  The setup constants move to
    ``device`` once, here; the step keeps no per-job state.
    """
    consts = {s.name: {k: torch.as_tensor(np.asarray(v), device=device)
                       for k, v in s.setup(m, p).items()}
              for s in specs if s.setup is not None}

    def features_out(ctx, lead, several):
        out = {}
        for s in specs:
            if s.ragged:
                counts, rows = s.compute(ctx)
                out[s.name] = {
                    "counts": counts.reshape(lead),
                    "rows": rows.reshape(lead + tuple(rows.shape[1:]))}
            else:
                val = s.compute(ctx)
                if (several or s.shape is not None) \
                        and ctx.graphs.owns(val):
                    val = val.clone()
                out[s.name] = val.reshape(lead + tuple(val.shape[1:]))
        return out

    def shard_step(payload, scales, graphs, several):
        if device_synth:
            idx = np.asarray(payload)
            records = torch.stack([synth_record(int(i), m, device)
                                   for i in idx.reshape(-1)])
            records = records.reshape(*idx.shape, m.record_size)
        else:
            records = payload
        lead = tuple(records.shape[:-1])
        ctx = FeatureContext(
            records.reshape(-1, records.shape[-1]), p, use_kernels, consts,
            scales=None if scales is None else scales.reshape(-1),
            graphs=graphs)
        return features_out(ctx, lead, several)

    def step(payload, scales=None, graphs=None):
        # one call per logical shard row: no op ever sees a row count
        # that depends on how many executors share the step, so every
        # executor count dividing n_shards gives the same bits
        n = payload.shape[0]
        if n == 1:
            return shard_step(payload, scales, graphs, False)
        return _cat_outputs([
            shard_step(payload[s:s + 1],
                       None if scales is None else scales[s:s + 1],
                       graphs, True)
            for s in range(n)], device)

    return step


def _cat_outputs(parts: list[dict], device: torch.device) -> dict:
    """Concatenate step outputs (``{name: tensor}`` or ``{name:
    {"counts", "rows"}}``) along the shard axis, in order, onto
    ``device``.  A copy from another device is ordered against both
    devices' current streams by events inside ``Tensor.to``: nothing
    waits on the host."""
    def cat(ts):
        ts = [t.to(device, non_blocking=True) for t in ts]
        return ts[0] if len(ts) == 1 else torch.cat(ts, dim=0)

    out = {}
    for name, v in parts[0].items():
        if isinstance(v, dict):
            out[name] = {k: cat([p_[name][k] for p_ in parts]) for k in v}
        else:
            out[name] = cat([p_[name] for p_ in parts])
    return out


@dataclasses.dataclass(frozen=True)
class ReductionBinding:
    """One reduction resolved against a concrete window: the engine's
    unit of carry state."""

    feature: str                    # name of the feature value it reads
    red: Reduction
    wkey: str                       # resolved window routing key
    n_windows: int
    fields: tuple[StateField, ...]  # red.init(m, p), resolved once

    @property
    def out_name(self) -> str:
        return self.red.out_name

    @property
    def to_epoch(self) -> bool:
        """Declared-epoch reductions publish (squeezed) to
        ``JobResult.epoch``; everything else is a windowed output."""
        return self.red.window.kind == "epoch"


def _sk(b: ReductionBinding, field: str) -> str:
    """Carry/commit key for one state field — the reference's naming,
    so either package resumes the other's committed carry."""
    return f"__r:{b.wkey}:{b.out_name}:{field}"


def _state_keys(b: ReductionBinding):
    """One binding's carry keys: each field's, and the Kahan companion
    of each ``ksum`` field."""
    for f in b.fields:
        yield _sk(b, f.name)
        if f.merge == "ksum":
            yield _sk(b, f.name) + ":c"


def resolve_bindings(specs, m: DatasetManifest, p: DepamParams,
                     job_window: Window | None
                     ) -> tuple[tuple[ReductionBinding, ...],
                                dict[str, Window]]:
    """Bind every selected reduction to its concrete window; returns the
    bindings plus the distinct resolved windows by routing key."""
    job_window = job_window or EPOCH_WINDOW
    bindings: list[ReductionBinding] = []
    windows: dict[str, Window] = {}
    owner: dict[str, str] = {}
    for s in specs:
        for red in s.reductions:
            win = job_window if red.window.kind == "job" else red.window
            if red.out_name in owner:
                raise ValueError(
                    f"reduction output {red.out_name!r} declared by both "
                    f"{owner[red.out_name]!r} and {s.name!r} — outputs "
                    f"must be unique across the selected features")
            owner[red.out_name] = s.name
            windows[win.key] = win
            bindings.append(ReductionBinding(
                feature=s.name, red=red, wkey=win.key,
                n_windows=win.n_windows(m), fields=tuple(red.init(m, p))))
    return tuple(bindings), windows


def _window_rows(wids: dict[str, np.ndarray]
                ) -> tuple[dict[str, list], np.ndarray]:
    """Host half of the fixed-order segment reduce.

    ``wids`` maps each window key to the step's ``(n_shards, chunk)``
    window ids.  Returns ``segments[key]``, per logical shard the window
    ids the step hits (ascending) each with the ``[lo, hi)`` range of its
    row indices, and one flat int64 array: those row indices (into the
    shard's own rows), then for each key in turn the ids of the windows
    the step hits, ascending (:func:`_hit_offsets`).  With the step's
    live mask appended (:func:`_carry_index`) it ships to the device
    with the step's other host arrays."""
    segments, parts, n = {}, [], 0
    for key, w in wids.items():
        per_shard = []
        for ws in w.reshape(w.shape[0], -1):
            runs = []
            for wid in np.unique(ws):
                r = np.flatnonzero(ws == wid)
                runs.append((int(wid), n, n + r.size))
                parts.append(r)
                n += r.size
            per_shard.append(runs)
        segments[key] = per_shard
    parts += [np.asarray([w for w, _ in _window_hits(runs)])
              for runs in segments.values()]
    rows = np.concatenate(parts) if parts else np.zeros(0)
    return segments, rows.astype(np.int64)


_COMBINE = {"sum": torch.add, "ksum": torch.add, "min": torch.minimum,
            "max": torch.maximum}


def _window_hits(shard_runs) -> list[tuple[int, list]]:
    """The windows a step hits, ascending, each with the ``(shard, lo,
    hi)`` row ranges of the shards that hit it, in ascending shard
    order."""
    hits: dict[int, list] = {}
    for s, runs in enumerate(shard_runs):
        for w, lo, hi in runs:
            hits.setdefault(w, []).append((s, lo, hi))
    return sorted(hits.items())


def _carry_index(rows: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """What the carry update reads of the host's step: the row indices
    and hit window ids of :func:`_window_rows`, then the ``(n_shards,
    chunk)`` live mask as 0/1, in one int64 array (one copy to the
    device)."""
    return np.concatenate([rows, np.asarray(mask, np.int64).reshape(-1)])


def _hit_offsets(segments) -> tuple[dict[str, int], int, int]:
    """Where each key's hit window ids start in :func:`_carry_index`'s
    array (after every row index, keys in order), where the live mask
    starts, and its length (the step's rows)."""
    rows = n = sum(hi - lo for runs in segments.values() for shard in runs
                   for _, lo, hi in shard)
    out = {}
    for key, runs in segments.items():
        out[key] = n
        n += len({w for shard in runs for w, _, _ in shard})
    return out, n, rows // len(segments)


def _window_partial(merge: str, contribs: torch.Tensor, ranges,
                    rows: torch.Tensor) -> torch.Tensor:
    """One window's partial: per shard that hits it, one reduction over
    the rows ``rows[lo:hi]`` of its contributions ``contribs[shard]``,
    merged in ascending shard order (a resumed partitioned plan keeps
    its shard count, so the order of every add is fixed by the plan)."""
    part = None
    for s, lo, hi in ranges:
        sel = contribs[s].index_select(0, rows[lo:hi])
        if merge in ("sum", "ksum"):
            red = sel.sum(dim=0, dtype=contribs.dtype)
        elif merge == "min":
            red = sel.amin(dim=0)
        else:
            red = sel.amax(dim=0)
        part = red if part is None else _COMBINE[merge](part, red)
    return part


def _merge_rows(merge: str, row, comp, part):
    """``row ⊕= part`` in place (``comp``: the Kahan companion of a
    ``ksum`` row), on views or on gathered copies alike."""
    if merge == "ksum":
        y = part - comp
        t = row + y
        # zero partials are exact no-ops: without the where, the
        # float32 (s, c) rotation would keep perturbing the row,
        # breaking the byte identity between rows flushed mid-job and
        # the job-end recompute
        zero = part == 0
        torch.where(zero, comp, (t - row) - y, out=comp)
        torch.where(zero, row, t, out=row)
    elif merge == "sum":
        row.add_(part)
    else:
        _COMBINE[merge](row, part, out=row)


def compile_reduce_update(bindings: tuple[ReductionBinding, ...]
                          ) -> Callable:
    """Multi-window carry update, in place: state ⊕= step contributions.

    Takes ``(state, outputs, segments, index, graphs)``: ``state`` maps
    ``__r:<window>:<out>:<field>`` to an ``(n_windows, *shape)`` device
    tensor (plus ``:c`` Kahan companions), ``segments`` is
    :func:`_window_rows` of the step's window ids, ``index`` its
    :func:`_carry_index` (row indices, hit window ids, live mask) on the
    device, and ``graphs`` the job's
    :class:`~repro_torch.api.graphs.StepGraphs` (None: eager).  Only the
    rows of the windows the step hits are written, each in place; the
    state mapping itself is returned.  A window no record of the step
    hits would merge the identity, which leaves its row as it is, so the
    rows come out with the bits of a full-size ``state ⊕ partial``.

    The update is one chain of ``graphs``, keyed on the segment layout
    without the window ids: each hit window's rows are gathered by the
    ids in ``index`` (``index_select``), merged with the same ops in the
    same order as one row at a time, and scattered back
    (``index_copy_``; ``index_add_`` for a ``sum``, whose one add per
    element has the bits of ``add_``), so a captured graph serves every
    step of that layout.  A key of one window (the epoch) merges into
    the view of its only row.
    """
    features = tuple(dict.fromkeys(b.feature for b in bindings))

    def update(state, out, segments, index, graphs=None):
        if not bindings:
            return state
        graphs = graphs or StepGraphs()
        offsets, m0, n_rows = _hit_offsets(segments)
        layout = {key: tuple(tuple(r) for _, r in _window_hits(runs))
                  for key, runs in segments.items()}
        n_shards = len(next(iter(segments.values())))

        def chain(*inputs):
            vals = dict(zip(features, inputs))
            rows_ = inputs[-1]
            fmask = rows_[m0:m0 + n_rows] != 0
            for b in bindings:
                val = vals[b.feature]
                val = val.reshape((-1,) + tuple(val.shape[2:]))
                contribs = b.red.update(val, fmask)
                hits = layout[b.wkey]
                off = offsets[b.wkey]
                wid = rows_[off:off + len(hits)]
                for f in b.fields:
                    c = contribs[f.name]
                    c = c.reshape((n_shards, -1) + tuple(c.shape[1:]))
                    key = _sk(b, f.name)
                    parts = [_window_partial(f.merge, c, ranges, rows_)
                             for ranges in hits]
                    dst = state[key]
                    cdst = state.get(key + ":c")
                    if b.n_windows == 1:
                        _merge_rows(f.merge, dst[0],
                                    None if cdst is None else cdst[0],
                                    parts[0])
                        continue
                    part = parts[0][None] if len(parts) == 1 \
                        else torch.stack(parts)
                    if f.merge == "sum":
                        dst.index_add_(0, wid, part)
                        continue
                    row = dst.index_select(0, wid)
                    comp = None if cdst is None else cdst.index_select(0, wid)
                    _merge_rows(f.merge, row, comp, part)
                    dst.index_copy_(0, wid, row)
                    if comp is not None:
                        cdst.index_copy_(0, wid, comp)
            return ()

        structure = (tuple(sorted(layout.items())),
                     tuple(sorted(offsets.items())),
                     tuple(t.data_ptr() for t in state.values()))
        graphs.run("carry", chain,
                   tuple(out[f] for f in features) + (index,),
                   structure)
        return state

    return update


_STATE_DTYPES = {"float32": torch.float32, "int32": torch.int32}


def _init_reduce_state(bindings, resumed, device: torch.device):
    """Device-resident multi-window carry, seeded from committed state.

    Every state field (ksum compensations included) rides commit/resume
    verbatim, so a resumed accumulation is bitwise-identical to an
    uninterrupted one.  A cursor whose carry keys do not exactly match
    the selected reductions is refused.
    """
    state = {}
    for b in bindings:
        for f in b.fields:
            key = _sk(b, f.name)
            shape = (b.n_windows,) + tuple(f.shape)
            state[key] = torch.full(shape, f.init,
                                    dtype=_STATE_DTYPES[f.dtype],
                                    device=device)
            if f.merge == "ksum":
                state[key + ":c"] = torch.zeros(shape, dtype=torch.float32,
                                                device=device)
    if resumed is None:
        return state
    carry = carry_from_reference(resumed[0], device)
    unknown = sorted(set(carry) - set(state))
    missing = sorted(set(state) - set(carry))
    if unknown or missing:
        raise ValueError(
            f"cannot resume: committed aggregate state does not match the "
            f"selected reductions (stale keys {unknown}, absent keys "
            f"{missing}) — the feature/reduction/window set changed since "
            f"the cursor was written; use a fresh store directory")
    for name, total in carry.items():
        if tuple(total.shape) != tuple(state[name].shape):
            raise ValueError(
                f"cannot resume: committed aggregate {name!r} has shape "
                f"{tuple(total.shape)}, expected "
                f"{tuple(state[name].shape)} (window resolution or params "
                f"changed since the cursor was written); use a fresh "
                f"store directory")
        state[name] = total.to(state[name].dtype)
    return state


def _finalize_rows(b: ReductionBinding, host_state: dict,
                   lo: int, hi: int) -> np.ndarray:
    """Finalize rows [lo, hi) of one binding's host arrays: those rows
    of the float32 carry widened to float64 (exact), ksum fields
    corrected, so mid-job flushes and the job-end pass give
    byte-identical rows."""
    st = {}
    for f in b.fields:
        key = _sk(b, f.name)
        arr = np.asarray(host_state[key][lo:hi], np.float64)
        if f.merge == "ksum":
            arr = arr - np.asarray(host_state[key + ":c"][lo:hi],
                                   np.float64)
        st[f.name] = arr
    return np.asarray(b.red.finalize(st))


def _closed_windows(edges: np.ndarray, cursor: int) -> int:
    """How many leading windows lie entirely below the commit cursor."""
    return int(np.searchsorted(edges[1:], cursor, side="right"))


class Compiler:
    """Where a stepper gets its step and carry-update functions from —
    the seam a serving layer's shared cache plugs into."""

    def step(self, specs, m, p, use_kernels, device_synth, device) -> Callable:
        return compile_step(specs, m, p, use_kernels, device_synth, device)

    def reduce(self, bindings) -> Callable:
        return compile_reduce_update(bindings)


DEFAULT_COMPILER = Compiler()


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


class _HostToDevice:
    """One job's host->device path.

    On a CUDA device each step's host arrays are copied into pinned
    staging buffers (one set per slot, slots used in turn), then into
    fresh device tensors with ``non_blocking`` copies on a dedicated
    copy stream; the compute stream waits on the copy's event.  A slot
    is refilled only after the copy that last read it has completed, and
    every device tensor is marked as used by the compute stream, so the
    caching allocator does not hand its memory out while a kernel may
    still read it.  ``staging`` hands out the next slot's payload
    buffer, to be filled in place; the next ``ship`` must then be given
    that buffer as its ``payload`` and does not copy it.  On the CPU the
    arrays become tensors in place.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self._slots = [{} for _ in range(max(2, slots))]
            self._copied: list = [None] * len(self._slots)
            self._next = 0
            self._staged = None     # the payload buffer staging() gave

    def _pinned(self, slot: int, name: str, shape: tuple,
                dtype: np.dtype) -> torch.Tensor:
        """Slot ``slot``'s pinned buffer for ``name``, viewed as
        ``shape``; (re)allocated when too small or of another dtype."""
        bufs = self._slots[slot]
        dtype = _TORCH_DTYPES[np.dtype(dtype)]
        size = math.prod(shape)
        buf = bufs.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < size:
            buf = bufs[name] = torch.empty(size, dtype=dtype,
                                           pin_memory=True)
        return buf[:size].view(shape)

    def _free(self, slot: int) -> None:
        """Wait for the copy that last read ``slot``."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
            self._copied[slot] = None

    def staging(self, shape: tuple, dtype) -> np.ndarray:
        """The next slot's pinned payload buffer, as an array to fill in
        place and hand to the next ``ship`` as ``payload`` (CUDA only)."""
        self._free(self._next)
        self._staged = self._pinned(self._next, "payload", tuple(shape),
                                    dtype).numpy()
        return self._staged

    def ship(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        if not self.cuda:
            return {k: torch.as_tensor(a) for k, a in arrays.items()}
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        self._free(slot)
        staged, self._staged = self._staged, None
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self.stream):
            for name, a in arrays.items():
                a = np.ascontiguousarray(a)
                host = self._pinned(slot, name, a.shape, a.dtype)
                if name == "payload" and staged is not None:
                    if a.ctypes.data != staged.ctypes.data \
                            or a.shape != staged.shape:
                        raise RuntimeError(
                            "ship's payload is not the buffer that "
                            "staging() handed out")
                else:
                    with trace.span("h2d.stage"):
                        np.copyto(host.numpy(), a)
                # allocated on the copy stream, which writes it first
                dev = torch.empty(a.shape, dtype=host.dtype,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                dev.record_stream(compute)
                out[name] = dev
            done = torch.cuda.Event()
            done.record(self.stream)
        self._copied[slot] = done
        compute.wait_event(done)
        return out


class _DeviceToHost:
    """One job's device->host path.

    ``start`` (at dispatch) copies a step's device tensors into FRESH
    pinned host tensors on a second stream, after the compute stream's
    work so far, and returns the step's pending copy; ``wait`` (at
    drain) waits on that copy's event alone and returns numpy views.  A
    pinned buffer is never refilled while a view of it is alive (the
    host allocator recycles it only once freed), so arrays taken from it
    stay the receiver's own.  On the CPU ``start`` returns numpy views
    of the tensors themselves where no later step writes them, and
    copies of those that later steps rewrite in place
    (``rewritten=True``: the whole carry); on CUDA the caller orders
    such a rewrite after the copy's event.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)

    def start(self, tensors: dict, rewritten: bool = False) -> tuple:
        if not self.cuda:
            return None, {k: (t.clone() if rewritten else t).numpy()
                          for k, t in tensors.items()}
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        host = {}
        with torch.cuda.stream(self.stream):
            for k, t in tensors.items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(self.stream)
                host[k] = h
            done = torch.cuda.Event()
            done.record(self.stream)
        return done, host

    def wait(self, pending: tuple) -> dict:
        done, host = pending
        if done is None:
            return host
        done.synchronize()
        return {k: h.numpy() for k, h in host.items()}


class JobStepper:
    """One job as a resumable sequence of bounded step quanta.

    This is the schedulable unit of the serving layer: ``run_job`` (and
    ``SoundscapeJob.run``) execute ``start -> step_once* -> finish ->
    close`` back to back, while a :class:`~repro_torch.serve.
    SoundscapeService` interleaves ``step_once`` calls of many steppers
    over one device.  All per-job state (the carry on the device, the
    in-flight queue, the pinned staging slots and copy streams, the
    source stream and the window-flush watermarks) lives on the
    instance, so pausing a stepper between steps changes no bit.  A
    stepper starts and steps on ONE thread: the copy streams order
    themselves against that thread's current stream.

    ``start()`` binds the source, builds the step, opens the sink and
    restores committed state; ``step_once()`` dispatches one plan step
    and drains the oldest in-flight steps past ``options.inflight``
    into the sink (returning False when none remain); ``finish()``
    drains the rest and finalizes windows and epoch aggregates;
    ``close()`` releases source, sink and the device-side state (carry,
    staging slots, streams) and must run even when another method
    raised.  ``poll()`` is the non-blocking readiness probe the
    scheduler uses to skip tenants whose live source has no data yet;
    a live source whose stream ended (``Source.stream_end``) masks the
    records it will never deliver, and the job finishes over what
    arrived.

    Under a mesh (``mesh``/``data_axes``, see ``launch.mesh``) the step
    runs on ``D`` executors, one ``torch.device`` each (repeats
    allowed), each owning ``n_shards / D`` consecutive shard rows:

      1. placement — each executor receives only its rows, through its
         own pinned staging slots and copy stream;
      2. compute — the step runs on each executor over its own rows, one
         call per logical shard;
      3. merge — the outputs are concatenated in shard order onto the
         first executor's device, ordered by stream events;
      4. reduction — the carry, which lives on the first executor,
         merges the per-shard partials in ascending shard order.

    The shard count and the merge order are fixed by the plan, never by
    ``D``, so every ``D`` dividing ``n_shards`` gives the same bits, and
    a store committed at one ``D`` resumes at another.

    ``quarantine`` (``faults.Quarantine``, shared with the
    ``ResilientSource`` that fills it) is the job's bad-record set:
    quarantined records are masked out of the step after their payload
    is fetched, and the set rides every commit.  None is strict mode.
    ``instrument`` (``meta.Instrument`` or None) is the calibration
    provenance, handed to the sink before ``open``: resumable sinks
    commit it with the cursor, labeled sinks stamp it on their attrs.

    ``host_seconds`` accumulates the driver thread's wall time per phase
    of a step: ``h2d`` (staging and enqueueing the host->device copies),
    ``dispatch`` (enqueueing the step, the merge, the carry update and
    the device->host copies), ``d2h_wait`` (waiting for a drained step's
    copies) and ``sink`` (compaction and the sink calls; with an
    AsyncSink, the enqueue).  With :mod:`repro_torch.trace` on, the same
    clock reads also make spans: ``job.step`` (one plan step, attribute
    ``step``) holds the source's spans (``LiveSource``: ``source.wait``,
    ``source.copy``), ``job.h2d`` (= ``h2d``; on CUDA its children
    ``h2d.stage`` are the copies into pinned memory; a source with
    ``fetch_into`` on one CUDA executor fills the payload's pinned
    buffer during its fetch, and ``ship`` does not copy it again),
    ``job.dispatch`` (= ``dispatch``; its attributes ``replays``,
    ``captures`` and ``eager`` count the step's chain runs by how
    :class:`~repro_torch.api.graphs.StepGraphs` served them; its child
    ``job.carry`` is the carry update and the start of the carry's copy
    to the host, with the window rows it writes, ``windows``, and the
    carry bytes it sends, ``d2h_bytes``) and, where the step drains,
    ``job.drain`` (= ``d2h_wait`` + ``sink``; its ``step`` is the step
    drained), whose
    children are ``drain.compact`` (the event compaction: ``records``,
    ``events`` kept, ``overflow``: records whose true count exceeds the
    capacity) and ``job.flush`` (the closed windows written: ``windows``,
    ``bytes``).

    The carry reaches the host only for a sink that takes commits
    (``wants_commit``): a resumable sink's commit gets the whole carry
    as it stood after its step; any other gets no carry, and the drain
    flushes the windows a step closes from a copy of those rows alone,
    made at dispatch (closed rows are never written again).
    """

    def __init__(self, m: DatasetManifest, p: DepamParams,
                 specs: list[FeatureSpec], source: Source, sink: Sink,
                 pl_: ShardPlan, use_kernels: bool,
                 max_steps: int | None = None,
                 options: ExecOptions | None = None,
                 window: Window | None = None,
                 compiler: Compiler | None = None,
                 device: torch.device = torch.device("cuda"),
                 mesh=None, data_axes: tuple[str, ...] = ("data",),
                 quarantine=None, instrument=None):
        self.m = m
        self.p = p
        self.instrument = instrument
        self.specs = tuple(specs)
        self.source = source
        self.sink = sink
        self.pl = pl_
        self.use_kernels = use_kernels
        self.max_steps = max_steps
        self.options = options or ExecOptions()
        self.window = window
        self.compiler = compiler or DEFAULT_COMPILER
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.executors = (torch.device(device),) if mesh is None else \
            partition_lib.shard_sharding(mesh, self.data_axes)
        # the carry and the merged outputs live on the first executor
        self.device = self.executors[0]
        self.quarantine = quarantine
        self.host_seconds = dict.fromkeys(
            ("h2d", "dispatch", "d2h_wait", "sink"), 0.0)
        self._started = False
        self._closed = False
        self._result = None
        self._exhausted = False      # live stream ended before the plan
        self._stream = None
        self._h2d: list = []
        self._d2h = None
        self._inflight: collections.deque = collections.deque()
        self._windows_out: dict[str, np.ndarray] = {}
        self._overflowed = False     # event-capacity warning fired once
        self._carry_read = None      # event of the last whole-carry copy
        self._graphs: list[StepGraphs] = []

    def start(self) -> "JobStepper":
        """Bind, build, open the sink, restore committed state.  A
        committed plan whose geometry differs from this job's wins, so a
        resume replays the exact logical layout it was written under,
        over however many executors this job has."""
        committed = self.sink.committed_plan()
        if committed is not None:
            self.pl = partition_lib.adopt_plan(self.pl, committed)
        m, p, pl_ = self.m, self.p, self.pl
        n_dev = len(self.executors)
        if n_dev > pl_.n_shards or pl_.n_shards % n_dev:
            raise ValueError(
                f"plan has {pl_.n_shards} logical shard(s), which cannot "
                f"be laid out over {n_dev} data-parallel executor(s) "
                f"(mesh {self.mesh.shape}, data axes {self.data_axes}) "
                f"— the executor count must divide the shard count; "
                f"pick .shards(L) with L % executors == 0, or build a "
                f"smaller mesh")
        self.source = source = self.source.bind(m, p)
        self._shapes = {s.name: tuple(s.shape(m, p)) for s in self.specs
                        if s.shape is not None}
        self._ragged = {s.name: s for s in self.specs if s.ragged}

        bindings, wins = resolve_bindings(self.specs, m, p, self.window)
        self._bindings = bindings
        self._wins = wins
        self._windowed = tuple(b for b in bindings if not b.to_epoch)
        self._edges = {b.out_name: wins[b.wkey].edges(m)
                       for b in self._windowed}

        self._raw = not source.device_synth \
            and source.payload_dtype == "int16"
        step_fns = {}
        for dev in self.executors:
            if dev not in step_fns:
                step_fns[dev] = self.compiler.step(
                    self.specs, m, p, self.use_kernels,
                    source.device_synth, dev)
        self._step_fns = [step_fns[dev] for dev in self.executors]
        self._agg_fn = self.compiler.reduce(bindings)
        # the chains' graphs are the job's own, one set per executor (the
        # carry's with the first): the step and carry functions may be
        # shared between jobs and keep no per-job state
        self._graphs = [StepGraphs(dev) for dev in self.executors]

        self.sink.set_instrument(self.instrument)
        self.sink.open(m, p, self._shapes, pl_)
        if self._windowed:
            self.sink.open_windows({
                b.out_name: (b.n_windows,) + tuple(b.red.out_shape(m, p))
                for b in self._windowed})
            # labeled sinks derive per-window time coordinates from
            # these record-offset edges (manifest.record_times)
            self.sink.open_window_edges(
                {name: e.copy() for name, e in self._edges.items()})
        if self._ragged:
            # capacity is a params knob, so every ragged feature of a
            # job shares p.event_capacity
            self.sink.open_events({
                name: (s.columns, p.event_capacity)
                for name, s in self._ragged.items()})
        start_step, resumed = self.sink.resume_state()
        if resumed is not None:
            # the quarantine set rides the commit as an opaque carry key:
            # strip it before the strict key match and restore it into
            # this run's set, so resumed masking (and the spent budget)
            # equals the uninterrupted run's
            prev_agg, prev_live = resumed
            q = prev_agg.pop("__quarantine__", None)
            if q is not None and np.asarray(q).size:
                if self.quarantine is None:
                    raise ValueError(
                        f"cannot resume: the committed cursor carries "
                        f"{np.asarray(q).size} quarantined record(s) but "
                        f"this job does not tolerate bad records; re-run "
                        f"with .tolerate(bad_records="
                        f"{np.asarray(q).size}) or more, or use a fresh "
                        f"store directory")
                self.quarantine.seed(q)
            resumed = (prev_agg, prev_live)
        self._agg_state = _init_reduce_state(bindings, resumed, self.device)

        self._n_steps = pl_.n_steps if self.max_steps is None \
            else min(pl_.n_steps, self.max_steps)
        self._step = start_step
        # windows already flushed durably: everything closed below the
        # committed cursor (their rows landed before that commit)
        start_cursor = pl_.cursor_after(start_step - 1) if start_step > 0 \
            else pl_.start
        self._flushed = {
            b.out_name: _closed_windows(self._edges[b.out_name],
                                        start_cursor)
            if start_step > 0 else 0
            for b in self._windowed}
        # what the carry copy at dispatch holds: the whole carry, the
        # closed windows' rows (``_shipped``: the windows copied so far),
        # or nothing
        self._commit = None if not self.sink.wants_commit else \
            "all" if self.sink.resumable else "closed"
        self._shipped = dict(self._flushed)
        # live records dispatched, the committed count included: what
        # each commit and the job's result report
        self._live = 0 if resumed is None else int(resumed[1])
        self._h2d = [_HostToDevice(dev, self.options.inflight + 1)
                     for dev in self.executors]
        self._d2h = _DeviceToHost(self.device)
        # a source that can fill a buffer in place (a live ring) fills
        # the step's pinned staging slot itself, each record as it lands,
        # where one CUDA executor stages the whole step
        self._fill_slot = self._h2d[0].cuda and n_dev == 1 \
            and hasattr(source, "fetch_into")
        self._stream = None if source.device_synth or self._fill_slot \
            else source.stream(pl_, start_step, self._n_steps)
        self._started = True
        return self

    @property
    def step(self) -> int:
        """The next plan step to dispatch."""
        return self._step if self._started else 0

    @property
    def n_steps(self) -> int:
        return self._n_steps if self._started else self.pl.n_steps

    @property
    def records_done(self) -> int:
        """Records covered by already-dispatched steps."""
        if not self._started or self._step == 0:
            return 0
        return self.pl.committed_records(self._step - 1)

    @property
    def done(self) -> bool:
        return self._started and (self._result is not None
                                  or self._exhausted
                                  or self._step >= self._n_steps)

    def _live_mask(self, idx: np.ndarray) -> np.ndarray:
        """The step's live mask, also excluding the records a finite
        (ended) live stream will never deliver.  For every other source
        ``stream_end()`` is None and the plan mask passes through
        untouched."""
        mask = self.pl.step_mask(self._step)
        end = self.source.stream_end()
        if end is not None:
            mask = mask & (idx < end)
        return mask

    def poll(self) -> str:
        """Non-blocking readiness: ``"ready"`` (step_once will not block
        on the source), ``"pending"`` (a live source still waiting for
        data), or ``"done"`` (no steps left — the plan is finished or
        the live stream ended)."""
        if not self._started:
            return "ready"          # start() is the next unit of work
        if self.done:
            return "done"
        idx = self.pl.step_indices(self._step)
        mask = self._live_mask(idx)
        if not mask.any() and self.source.stream_end() is not None:
            return "done"
        return self.source.poll(idx[mask])

    def _fetch(self, idx: np.ndarray, mask: np.ndarray) -> tuple:
        """The step's host inputs: payload and int16 decode scales (None
        for device synthesis) and the live mask.  The payload is fetched
        BEFORE the mask is frozen: a tolerant source may quarantine
        records of this very step while reading them, and a quarantined
        record is masked out of every reduction (its per-record rows are
        never written)."""
        payload = scales = None
        if not self.source.device_synth:
            if self._fill_slot:
                payload = self.source.fetch_into(idx, self._h2d[0].staging(
                    idx.shape + (self.m.record_size,),
                    self.source.payload_dtype))
            else:
                payload = np.asarray(next(self._stream))
            if self._raw:
                if payload.dtype != np.int16:
                    raise TypeError(
                        f"int16 payload path got {payload.dtype} from "
                        f"{type(self.source).__name__}.stream — the "
                        f"source's payload_dtype promises raw '<i2' PCM")
                scales = np.asarray(self.source.scales(idx), np.float32)
            else:
                payload = payload.astype(np.float32, copy=False)
        if self.quarantine is not None and len(self.quarantine):
            mask = mask & ~self.quarantine.mask_for(idx)
        return payload, scales, mask

    def step_once(self) -> bool:
        """Dispatch one plan step (and drain past ``inflight``); returns
        False when no step remains."""
        if not self._started:
            raise RuntimeError("JobStepper.step_once before start()")
        if self.done:
            return False
        step = self._step
        idx = self.pl.step_indices(step)
        mask = self._live_mask(idx)
        if not mask.any() and self.source.stream_end() is not None:
            # graceful end of stream: every remaining plan record lies
            # beyond what the live source will ever deliver
            self._exhausted = True
            return False
        with trace.span("job.step", step=step):
            self._run_step(step, idx, mask)
        return True

    def _run_step(self, step: int, idx: np.ndarray, mask: np.ndarray):
        """``step_once``'s work, inside its ``job.step`` span."""
        clock = time.perf_counter_ns
        segments, rows = _window_rows(
            {k: w.ids(idx, self.m) for k, w in self._wins.items()})
        payload, scales, mask = self._fetch(idx, mask)
        n_dev = len(self.executors)
        blocks = {k: partition_lib.split_rows(v, n_dev) for k, v in
                  (("payload", payload), ("scales", scales), ("idx", idx))
                  if v is not None}
        idx_blocks = blocks.pop("idx")
        t0 = clock()
        trace.begin("job.h2d", t0, step=step)
        devs = []
        for e, h2d in enumerate(self._h2d):
            arrays = {k: b[e] for k, b in blocks.items()}
            if e == 0:
                # what the carry update on the first executor reads
                arrays["index"] = _carry_index(rows, mask)
            devs.append(h2d.ship(arrays))
        t1 = clock()
        trace.end(t1)
        trace.begin("job.dispatch", t1, step=step)
        runs0 = self._chain_runs()
        outs = []
        for fn, dev, idx_e, g in zip(self._step_fns, devs, idx_blocks,
                                     self._graphs):
            if self.source.device_synth:
                outs.append(fn(idx_e, None, g))
            else:
                outs.append(fn(dev["payload"], dev.get("scales"), g))
        out = outs[0] if n_dev == 1 else _cat_outputs(outs, self.device)
        fetch = {("feature", name): out[name] for name in self._shapes}
        for name in self._ragged:
            fetch[("counts", name)] = out[name]["counts"]
            fetch[("rows", name)] = out[name]["rows"]
        pending = self._d2h.start(fetch)
        self._live += int(mask.sum())
        carry = self._update_carry(step, out, segments, devs[0]["index"])
        keep_alive = None if self.options.donate \
            else [d.get("payload") for d in devs]
        self._inflight.append((step, idx, mask, pending, carry,
                               keep_alive))
        self._step += 1
        for g in self._graphs:
            g.first_step = False
        runs = self._chain_runs()
        t2 = clock()
        trace.end(t2, **{k: runs[k] - runs0[k] for k in runs})
        self.host_seconds["h2d"] += (t1 - t0) / 1e9
        self.host_seconds["dispatch"] += (t2 - t1) / 1e9
        while len(self._inflight) > self.options.inflight:
            self._drain()

    def _chain_runs(self) -> dict:
        """The job's chain runs so far (``StepGraphs.counts``, summed
        over the executors)."""
        return {k: sum(g.counts[k] for g in self._graphs)
                for k in ("replays", "captures", "eager")}

    def _update_carry(self, step, out, segments, index):
        """The carry update, in place, and for a sink that takes commits
        the start of the carry's copy to the host, from THIS step's
        state: the whole carry for a resumable sink (the carry a commit
        persists must match the step's cursor, so the next update waits
        for the copy), else the rows of the windows this step's cursor
        closes, which no later step writes.  Returns None for a sink
        without commits, else ``(pending copy or None, {output: first
        row copied} or None for the whole carry, live count)``."""
        with trace.span("job.carry") as sp:
            if self._carry_read is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self._carry_read)
                self._carry_read = None
            self._agg_state = self._agg_fn(self._agg_state, out, segments,
                                           index, self._graphs[0])
            if self._commit is None:
                tensors, base = {}, None
            elif self._commit == "all":
                tensors, base = dict(self._agg_state), None
            else:
                tensors, base = {}, {}
                cursor = self.pl.cursor_after(step)
                for b in self._windowed:
                    lo = self._shipped[b.out_name]
                    hi = _closed_windows(self._edges[b.out_name], cursor)
                    if hi > lo:
                        tensors.update({k: self._agg_state[k][lo:hi]
                                        for k in _state_keys(b)})
                        base[b.out_name] = lo
                        self._shipped[b.out_name] = hi
            pending = None
            if tensors:
                pending = self._d2h.start(tensors,
                                          rewritten=self._commit == "all")
                if self._commit == "all":
                    self._carry_read = pending[0]
            if sp:
                sp.set(windows=sum(len(_window_hits(r))
                                   for r in segments.values()),
                       d2h_bytes=sum(t.numel() * t.element_size()
                                     for t in tensors.values()))
        return None if self._commit is None \
            else (pending, base, self._live)

    def _flush_closed(self, host_state, cursor, base=None):
        """Finalize + write every window the cursor just closed, BEFORE
        the commit that makes the cursor durable covers them.
        ``host_state`` holds the whole carry, or with ``base`` each
        output's rows from ``base[output]`` on."""
        with trace.span("job.flush") as sp:
            n = nbytes = 0
            for b in self._windowed:
                name = b.out_name
                lo = self._flushed[name]
                closed = _closed_windows(self._edges[name], cursor)
                if closed > lo:
                    off = 0 if base is None else base[name]
                    rows = _finalize_rows(b, host_state, lo - off,
                                          closed - off).astype(np.float32)
                    self.sink.write_windows(name, lo, rows)
                    self._flushed[name] = closed
                    n, nbytes = n + closed - lo, nbytes + rows.nbytes
            if sp:
                sp.set(windows=n, bytes=nbytes)

    def _drain(self):
        """Wait for the oldest in-flight step's copies, then write and
        commit it."""
        step, idx, mask, pending, carry, _keep_alive = \
            self._inflight.popleft()
        t0 = time.perf_counter_ns()
        trace.begin("job.drain", t0, step=step)
        host = self._d2h.wait(pending)
        if carry is not None:
            copied, base, live = carry
            carry_host = {} if copied is None else self._d2h.wait(copied)
        t1 = time.perf_counter_ns()
        keep = mask.reshape(-1)
        sel = idx.reshape(-1)[keep]
        # boolean selection copies: the sink gets arrays of its own
        values = {name: host[("feature", name)].reshape(
                      (-1,) + self._shapes[name])[keep]
                  for name in self._shapes}
        self.sink.write(step, sel, values)
        if self._ragged:
            with trace.span("drain.compact") as sp:
                ev = self._compact(host, keep)
                if sp:
                    cap = self.p.event_capacity
                    sp.set(records=int(keep.sum()),
                           events=max(len(r) for _, r in ev.values()),
                           overflow=max(int((c > cap).sum())
                                        for c, _ in ev.values()))
            self.sink.write_events(step, sel, ev)
        if carry is not None and base is not None:
            # closed rows only: the sink cannot resume, so its commit
            # carries no aggregate
            self._flush_closed(carry_host, self.pl.cursor_after(step), base)
            self.sink.commit(self.pl, step, {}, float(live))
        elif carry is not None:
            # the carry in its NATIVE dtypes (float32 / int32): resume
            # casts losslessly, _finalize_rows widens to float64 itself
            agg_host = dict(carry_host)
            if self.quarantine is not None:
                # a snapshot of the bad-record set rides the commit as an
                # opaque key (bad records are deterministic per record,
                # so a snapshot "ahead" of this step's cursor only
                # pre-masks records that would fail again anyway)
                agg_host["__quarantine__"] = self.quarantine.as_array()
            self._flush_closed(agg_host, self.pl.cursor_after(step))
            self.sink.commit(self.pl, step, agg_host, float(live))
        t2 = time.perf_counter_ns()
        trace.end(t2)
        self.host_seconds["d2h_wait"] += (t1 - t0) / 1e9
        self.host_seconds["sink"] += (t2 - t1) / 1e9

    def _compact(self, host, keep):
        """Host-side compaction: the device returned fixed-capacity
        slabs; only the first min(count, capacity) rows of each live
        record enter the append-only log, in record order."""
        ev = {}
        for name in self._ragged:
            counts = host[("counts", name)].reshape(-1)[keep]
            rows = host[("rows", name)]
            rows = rows.reshape((-1,) + rows.shape[-2:])[keep]
            cap = rows.shape[1]
            slot = np.arange(cap)[None, :] < np.minimum(counts, cap)[:, None]
            ev[name] = (counts.astype(np.int32),
                        rows[slot].astype(np.float32, copy=False))
            if not self._overflowed and (counts > cap).any():
                self._overflowed = True
                warnings.warn(
                    f"event capacity overflow in feature {name!r}: some "
                    f"records detected more than {cap} events; only the "
                    f"first {cap} are kept (raise "
                    f"DepamParams.event_capacity or the threshold). "
                    f"Affected records have counts > capacity in the "
                    f"event log.", RuntimeWarning, stacklevel=2)
        return ev

    def finish(self):
        """Drain the pipeline, finalize every window (trailing partial
        ones included) and the epoch aggregates; idempotent.  Returns
        (features, epoch, windows, window_edges, n_records, events,
        plan, quarantine) — see job.JobResult; ``events`` is the sink's
        {name: EventLog} for ragged features (None when the job has
        none, or the sink streams); ``quarantine`` the bad-record report
        (None unless the job tolerates bad records), with a
        RuntimeWarning whenever it names a record."""
        if not self._started:
            raise RuntimeError("JobStepper.finish before start()")
        if self._result is not None:
            return self._result
        while self._inflight:
            self._drain()
        host_state = {k: v.cpu().numpy() for k, v in self._agg_state.items()}
        for b in self._windowed:
            rows = _finalize_rows(b, host_state, 0, b.n_windows)
            self._windows_out[b.out_name] = rows.astype(np.float32)
            if self._flushed[b.out_name] < b.n_windows:
                self.sink.write_windows(
                    b.out_name, self._flushed[b.out_name],
                    self._windows_out[b.out_name][self._flushed[b.out_name]:])
                self._flushed[b.out_name] = b.n_windows
        epoch = {b.out_name: _finalize_rows(b, host_state, 0, 1)[0]
                 for b in self._bindings if b.to_epoch}
        window_edges = {name: self._edges[name].copy()
                        for name in self._windows_out}
        events = self.sink.event_result() if self._ragged else None
        qreport = None
        if self.quarantine is not None:
            qreport = self.quarantine.report()
            if qreport["records"]:
                warnings.warn(
                    f"{len(qreport['records'])} record(s) quarantined as "
                    f"bad data (budget {qreport['budget']}): "
                    f"{qreport['records']} — masked to reduction "
                    f"identities in aggregates, never written per "
                    f"record; see JobResult.quarantine for the "
                    f"per-record reasons", RuntimeWarning, stacklevel=2)
        self._result = (self.sink.result(), epoch, self._windows_out,
                        window_edges, self._live, events,
                        self.pl, qreport)
        return self._result

    def close(self):
        """Release stream, source and sink — all three, always; the first
        error re-raises after all three ran.  The device-side state (the
        carry, in-flight steps, pinned staging slots and copy streams)
        is dropped too, so a closed stepper a long-lived service still
        holds keeps no device or pinned memory."""
        if self._closed:
            return
        self._closed = True
        self._inflight.clear()
        self._h2d, self._d2h, self._carry_read = [], None, None
        self._graphs = []
        self._agg_state = self._step_fns = self._agg_fn = None
        first: BaseException | None = None
        for release in ((self._stream.close if self._stream is not None
                         else None),
                        self.source.close, self.sink.close):
            if release is None:
                continue
            try:
                release()
            except BaseException as e:   # noqa: BLE001 - re-raised below
                first = first or e
        if first is not None:
            raise first


def run_job(m: DatasetManifest, p: DepamParams, specs: list[FeatureSpec],
            source: Source, sink: Sink, pl_: ShardPlan, use_kernels: bool,
            max_steps: int | None, options: ExecOptions | None = None,
            window: Window | None = None,
            device: torch.device = torch.device("cuda"), mesh=None,
            data_axes: tuple[str, ...] = ("data",), quarantine=None,
            instrument=None):
    """Drive the job over plan ``pl_`` to completion; resumable when the
    sink is.  Returns (features, epoch, windows, window_edges,
    n_records, events, plan, quarantine)."""
    return drive(JobStepper(m, p, specs, source, sink, pl_, use_kernels,
                            max_steps, options, window, device=device,
                            mesh=mesh, data_axes=data_axes,
                            quarantine=quarantine, instrument=instrument))


def drive(stepper: JobStepper):
    """Run one stepper start-to-finish with guaranteed cleanup."""
    try:
        stepper.start()
        while stepper.step_once():
            pass
        return stepper.finish()
    finally:
        stepper.close()
