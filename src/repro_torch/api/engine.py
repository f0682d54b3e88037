"""The job engine: one step over all selected features per chunk.

Execution model (the paper's Fig 2.1): the *driver* is :func:`run_job`
— it owns the plan, runs one step per chunk, and commits progress
through the sink; the step runs every selected :class:`FeatureSpec`
against one shared :class:`FeatureContext`, so all features share the
Welch and per-frame PSDs and make a single pass over the data.

The reduction carry (epoch aggregates and multi-window LTSA/SPD/extrema
state) lives on the job's device across the whole job and is copied to
the host only at the commit boundaries of sinks that persist it, where
freshly closed windows are finalized and flushed just before the commit
that covers them.

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

  * host→device: each step's payload, mask, decode scales and window
    row indices are staged in pinned host buffers and copied with
    ``non_blocking`` on a dedicated copy stream; the compute stream
    (the current stream, on which every kernel launches) waits on that
    copy's CUDA event, so nothing in a step synchronizes the host;
  * device→host: at dispatch, the stored features, the ragged slabs
    and (for commit-consuming sinks) the carry as it stands after this
    step start copying into fresh pinned buffers on a second stream;
    draining a step waits on that step's event only;
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
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.compat import carry_from_reference
from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams
from repro_torch.distributed import partition as partition_lib
from .features import (EPOCH_WINDOW, FeatureContext, FeatureSpec,
                       Reduction, StateField, Window)
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
                 payload_dtype: str, device: torch.device) -> Callable:
    """Build the per-chunk step for all selected features.

    The step takes ``(payload, mask)`` — or ``(payload, mask, scales)``
    on the int16 path — where payload is host int indices (device
    synthesis) or a device tensor of float32 waveforms or raw int16 PCM,
    all with ``(n_shards, chunk)`` leading layout.  It returns
    ``{feature: (n_shards, chunk, *shape)}`` with padding slots set to
    each spec's fill value.  The setup constants move to ``device`` once,
    here.
    """
    consts = {s.name: {k: torch.as_tensor(np.asarray(v), device=device)
                       for k, v in s.setup(m, p).items()}
              for s in specs if s.setup is not None}

    def features_out(ctx, lead, mask):
        out = {}
        for s in specs:
            if s.ragged:
                # padding records' counts are zeroed, so the host-side
                # compaction drops their rows entirely
                counts, rows = s.compute(ctx)
                counts = torch.where(mask.reshape(-1), counts, 0)
                out[s.name] = {
                    "counts": counts.reshape(lead),
                    "rows": rows.reshape(lead + tuple(rows.shape[1:]))}
                continue
            val = s.compute(ctx)
            val = val.reshape(lead + tuple(val.shape[1:]))
            if s.shape is None:
                # reduction-only: the reductions mask padding slots
                out[s.name] = val
                continue
            fmask = mask.reshape(lead + (1,) * (val.ndim - len(lead)))
            # a Python scalar, not a tensor built per step: that would be
            # a blocking host->device copy
            out[s.name] = torch.where(fmask, val, float(s.fill))
        return out

    def shard_step(payload, mask, scales):
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
            scales=None if scales is None else scales.reshape(-1))
        return features_out(ctx, lead, mask)

    def step(payload, mask, scales=None):
        # one call per logical shard row: no op ever sees a row count
        # that depends on how many executors share the step, so every
        # executor count dividing n_shards gives the same bits
        n = mask.shape[0]
        if n == 1:
            return shard_step(payload, mask, scales)
        return _cat_outputs([
            shard_step(payload[s:s + 1], mask[s:s + 1],
                       None if scales is None else scales[s:s + 1])
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
    row indices, and those row indices (into the shard's own rows) as
    ONE flat int64 array, which ships to the device with the step's
    other host arrays."""
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
    rows = np.concatenate(parts) if parts else np.zeros(0)
    return segments, rows.astype(np.int64)


_IDENTITY = {"sum": 0.0, "ksum": 0.0, "min": float("inf"),
             "max": -float("inf")}


def _segment_reduce(merge: str, contribs: torch.Tensor, runs,
                    rows: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Reduce rows into window slots in a fixed order: for each window
    id of ``runs`` (host-known, ascending), one reduction over the rows
    ``rows[lo:hi]`` that hit it.  Absent windows hold the merge
    identity."""
    out = torch.full((n_windows,) + tuple(contribs.shape[1:]),
                     _IDENTITY[merge], dtype=contribs.dtype,
                     device=contribs.device)
    for w, lo, hi in runs:
        sel = contribs.index_select(0, rows[lo:hi])
        if merge in ("sum", "ksum"):
            red = sel.sum(dim=0, dtype=contribs.dtype)
        elif merge == "min":
            red = sel.amin(dim=0)
        else:
            red = sel.amax(dim=0)
        out[w] = red
    return out


_COMBINE = {"sum": torch.add, "ksum": torch.add, "min": torch.minimum,
            "max": torch.maximum}


def _merged_segments(merge: str, contribs: torch.Tensor, shard_runs,
                     rows: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Per-logical-shard window partials merged in ascending shard order
    (a resumed partitioned plan keeps its shard count, so the order of
    every add is fixed by the plan)."""
    n_shards = len(shard_runs)
    if n_shards == 1:
        return _segment_reduce(merge, contribs, shard_runs[0], rows,
                               n_windows)
    c = contribs.reshape((n_shards, -1) + tuple(contribs.shape[1:]))
    part = _segment_reduce(merge, c[0], shard_runs[0], rows, n_windows)
    for s in range(1, n_shards):
        part = _COMBINE[merge](part, _segment_reduce(
            merge, c[s], shard_runs[s], rows, n_windows))
    return part


def compile_reduce_update(bindings: tuple[ReductionBinding, ...]
                          ) -> Callable:
    """Multi-window carry update: state' = state ⊕ step contributions.

    Takes ``(state, outputs, mask, segments, rows)``: ``state`` maps
    ``__r:<window>:<out>:<field>`` to an ``(n_windows, *shape)`` device
    tensor (plus ``:c`` Kahan companions and the ``__live__`` count),
    ``mask`` is the step's ``(n_shards, chunk)`` live mask on the
    device, and ``segments``/``rows`` are :func:`_window_rows` of the
    step's window ids, the row indices on the device.
    """

    def update(state, out, mask, segments, rows):
        fmask = mask.reshape(-1)
        new = {}
        for b in bindings:
            val = out[b.feature]
            val = val.reshape((-1,) + tuple(val.shape[2:]))
            contribs = b.red.update(val, fmask)
            for f in b.fields:
                key = _sk(b, f.name)
                part = _merged_segments(f.merge, contribs[f.name],
                                        segments[b.wkey], rows,
                                        b.n_windows)
                if f.merge == "ksum":
                    y = part - state[key + ":c"]
                    t = state[key] + y
                    # zero partials are exact no-ops: without the where,
                    # the float32 (s, c) rotation would keep perturbing
                    # rows of already-CLOSED windows, breaking the byte
                    # identity between rows flushed mid-job and the
                    # job-end recompute
                    zero = part == 0
                    new[key + ":c"] = torch.where(
                        zero, state[key + ":c"], (t - state[key]) - y)
                    new[key] = torch.where(zero, state[key], t)
                elif f.merge == "sum":
                    new[key] = state[key] + part
                else:
                    new[key] = _COMBINE[f.merge](state[key], part)
        new["__live__"] = state["__live__"] \
            + mask.sum(dtype=torch.int32)
        return new

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
    state["__live__"] = torch.zeros((), dtype=torch.int32, device=device)
    if resumed is None:
        return state
    carry = carry_from_reference(*resumed, device)
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
    """Finalize window rows [lo, hi) of one binding on the host: the
    float32 carry widened to float64 (exact), ksum fields corrected, so
    mid-job flushes and the job-end pass give byte-identical rows."""
    st = {}
    for f in b.fields:
        key = _sk(b, f.name)
        arr = np.asarray(host_state[key], np.float64)[lo:hi]
        if f.merge == "ksum":
            arr = arr - np.asarray(host_state[key + ":c"],
                                   np.float64)[lo:hi]
        st[f.name] = arr
    return np.asarray(b.red.finalize(st))


def _closed_windows(edges: np.ndarray, cursor: int) -> int:
    """How many leading windows lie entirely below the commit cursor."""
    return int(np.searchsorted(edges[1:], cursor, side="right"))


class Compiler:
    """Where a stepper gets its step and carry-update functions from —
    the seam a serving layer's shared cache plugs into."""

    def step(self, specs, m, p, use_kernels, device_synth, payload_dtype,
             device) -> Callable:
        return compile_step(specs, m, p, use_kernels, device_synth,
                            payload_dtype, device)

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
    still read it.  On the CPU the arrays become tensors in place.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self._slots = [{} for _ in range(max(2, slots))]
            self._copied: list = [None] * len(self._slots)
            self._next = 0

    def ship(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        if not self.cuda:
            return {k: torch.as_tensor(a) for k, a in arrays.items()}
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        bufs = self._slots[slot]
        compute = torch.cuda.current_stream(self.device)
        out = {}
        with torch.cuda.stream(self.stream):
            for name, a in arrays.items():
                a = np.ascontiguousarray(a)
                dtype = _TORCH_DTYPES[a.dtype]
                buf = bufs.get(name)
                if buf is None or buf.dtype != dtype or buf.numel() < a.size:
                    buf = bufs[name] = torch.empty(a.size, dtype=dtype,
                                                   pin_memory=True)
                host = buf[:a.size].view(a.shape)
                np.copyto(host.numpy(), a)
                # allocated on the copy stream, which writes it first
                dev = torch.empty(a.shape, dtype=dtype, device=self.device)
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
    of the tensors themselves, which no later step writes.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)

    def start(self, tensors: dict) -> tuple:
        if not self.cuda:
            return None, {k: t.numpy() for k, t in tensors.items()}
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
    of a step: ``fetch`` (waiting for the source's payload), ``h2d``
    (staging and enqueueing the host->device copies), ``dispatch``
    (enqueueing the step, the merge, the carry update and the
    device->host copies), ``d2h_wait`` (waiting for a drained step's
    copies) and ``sink`` (compaction and the sink calls; with an
    AsyncSink, the enqueue).
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
            ("fetch", "h2d", "dispatch", "d2h_wait", "sink"), 0.0)
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
                    source.device_synth, source.payload_dtype, dev)
        self._step_fns = [step_fns[dev] for dev in self.executors]
        self._agg_fn = self.compiler.reduce(bindings)

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
        self._h2d = [_HostToDevice(dev, self.options.inflight + 1)
                     for dev in self.executors]
        self._d2h = _DeviceToHost(self.device)
        self._stream = None if source.device_synth \
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
            t0 = time.perf_counter()
            payload = np.asarray(next(self._stream))
            self.host_seconds["fetch"] += time.perf_counter() - t0
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
        clock = time.perf_counter
        step = self._step
        idx = self.pl.step_indices(step)
        mask = self._live_mask(idx)
        if not mask.any() and self.source.stream_end() is not None:
            # graceful end of stream: every remaining plan record lies
            # beyond what the live source will ever deliver
            self._exhausted = True
            return False
        segments, rows = _window_rows(
            {k: w.ids(idx, self.m) for k, w in self._wins.items()})
        payload, scales, mask = self._fetch(idx, mask)
        n_dev = len(self.executors)
        blocks = {k: partition_lib.split_rows(v, n_dev) for k, v in
                  (("mask", mask), ("payload", payload), ("scales", scales),
                   ("idx", idx)) if v is not None}
        idx_blocks = blocks.pop("idx")
        t0 = clock()
        devs = []
        for e, h2d in enumerate(self._h2d):
            arrays = {k: b[e] for k, b in blocks.items()}
            if e == 0:
                # what the carry update on the first executor reads
                arrays["rows"] = rows
                if n_dev > 1:
                    arrays["all_mask"] = mask
            devs.append(h2d.ship(arrays))
        t1 = clock()
        outs = []
        for fn, dev, idx_e in zip(self._step_fns, devs, idx_blocks):
            if self.source.device_synth:
                outs.append(fn(idx_e, dev["mask"]))
            else:
                outs.append(fn(dev["payload"], dev["mask"],
                               dev.get("scales")))
        out = outs[0] if n_dev == 1 else _cat_outputs(outs, self.device)
        cmask = devs[0]["all_mask" if n_dev > 1 else "mask"]
        self._agg_state = self._agg_fn(self._agg_state, out, cmask,
                                       segments, devs[0]["rows"])
        # what the drain reads, copied from THIS step's state: the carry
        # a commit persists must match the step's cursor, however many
        # steps have been dispatched since
        fetch = {("feature", name): out[name] for name in self._shapes}
        for name in self._ragged:
            fetch[("counts", name)] = out[name]["counts"]
            fetch[("rows", name)] = out[name]["rows"]
        commit = self.sink.wants_commit
        if commit:
            fetch.update({("carry", k): v
                          for k, v in self._agg_state.items()})
        pending = self._d2h.start(fetch)
        keep_alive = None if self.options.donate \
            else [d.get("payload") for d in devs]
        self._inflight.append((step, idx, mask, pending, commit,
                               keep_alive))
        self._step += 1
        self.host_seconds["h2d"] += t1 - t0
        self.host_seconds["dispatch"] += clock() - t1
        while len(self._inflight) > self.options.inflight:
            self._drain()
        return True

    def _flush_closed(self, host_state, cursor):
        """Finalize + write every window the cursor just closed, BEFORE
        the commit that makes the cursor durable covers them."""
        for b in self._windowed:
            closed = _closed_windows(self._edges[b.out_name], cursor)
            if closed > self._flushed[b.out_name]:
                rows = _finalize_rows(
                    b, host_state, self._flushed[b.out_name], closed)
                self.sink.write_windows(b.out_name,
                                        self._flushed[b.out_name],
                                        rows.astype(np.float32))
                self._flushed[b.out_name] = closed

    def _drain(self):
        """Wait for the oldest in-flight step's copies, then write and
        commit it."""
        step, idx, mask, pending, commit, _keep_alive = \
            self._inflight.popleft()
        t0 = time.perf_counter()
        host = self._d2h.wait(pending)
        t1 = time.perf_counter()
        keep = mask.reshape(-1)
        sel = idx.reshape(-1)[keep]
        # boolean selection copies: the sink gets arrays of its own
        values = {name: host[("feature", name)].reshape(
                      (-1,) + self._shapes[name])[keep]
                  for name in self._shapes}
        self.sink.write(step, sel, values)
        if self._ragged:
            self.sink.write_events(step, sel, self._compact(host, keep))
        if commit:
            # the carry in its NATIVE dtypes (float32 / int32): resume
            # casts losslessly, _finalize_rows widens to float64 itself
            agg_host = {k: v for (kind, k), v in host.items()
                        if kind == "carry" and k != "__live__"}
            if self.quarantine is not None:
                # a snapshot of the bad-record set rides the commit as an
                # opaque key (bad records are deterministic per record,
                # so a snapshot "ahead" of this step's cursor only
                # pre-masks records that would fail again anyway)
                agg_host["__quarantine__"] = self.quarantine.as_array()
            self._flush_closed(agg_host, self.pl.cursor_after(step))
            self.sink.commit(self.pl, step, agg_host,
                             float(host[("carry", "__live__")]))
        self.host_seconds["d2h_wait"] += t1 - t0
        self.host_seconds["sink"] += time.perf_counter() - t1

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
                        window_edges, int(host_state["__live__"]), events,
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
        self._h2d, self._d2h = [], None
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
