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
float32 one.  This slice has the synchronous executor; the pipelined
one (streams, pinned buffers, prefetch) is a later slice.
"""
from __future__ import annotations

import dataclasses
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
            out[s.name] = torch.where(
                fmask, val, torch.tensor(s.fill, dtype=val.dtype,
                                         device=val.device))
        return out

    def step(payload, mask, scales=None):
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

    return step


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


_IDENTITY = {"sum": 0.0, "ksum": 0.0, "min": float("inf"),
             "max": -float("inf")}


def _segment_reduce(merge: str, contribs: torch.Tensor, wids: np.ndarray,
                    n_windows: int) -> torch.Tensor:
    """Reduce rows into window slots in a fixed order: for each window
    id present in the step (host-known, ascending), one reduction over
    the rows that hit it.  Absent windows hold the merge identity."""
    out = torch.full((n_windows,) + tuple(contribs.shape[1:]),
                     _IDENTITY[merge], dtype=contribs.dtype,
                     device=contribs.device)
    for w in np.unique(wids):
        rows = torch.as_tensor(np.flatnonzero(wids == w),
                               device=contribs.device)
        sel = contribs.index_select(0, rows)
        if merge in ("sum", "ksum"):
            red = sel.sum(dim=0, dtype=contribs.dtype)
        elif merge == "min":
            red = sel.amin(dim=0)
        else:
            red = sel.amax(dim=0)
        out[int(w)] = red
    return out


_COMBINE = {"sum": torch.add, "ksum": torch.add, "min": torch.minimum,
            "max": torch.maximum}


def _merged_segments(merge: str, contribs: torch.Tensor, wids: np.ndarray,
                     n_windows: int, n_shards: int) -> torch.Tensor:
    """Per-logical-shard window partials merged in ascending shard order
    (a resumed partitioned plan keeps its shard count, so the order of
    every add is fixed by the plan)."""
    if n_shards == 1:
        return _segment_reduce(merge, contribs, wids.reshape(-1), n_windows)
    c = contribs.reshape((n_shards, -1) + tuple(contribs.shape[1:]))
    w = wids.reshape(n_shards, -1)
    part = _segment_reduce(merge, c[0], w[0], n_windows)
    for s in range(1, n_shards):
        part = _COMBINE[merge](part,
                               _segment_reduce(merge, c[s], w[s], n_windows))
    return part


def compile_reduce_update(bindings: tuple[ReductionBinding, ...]
                          ) -> Callable:
    """Multi-window carry update: state' = state ⊕ step contributions.

    Takes ``(state, outputs, mask, wids)``: ``state`` maps
    ``__r:<window>:<out>:<field>`` to an ``(n_windows, *shape)`` device
    tensor (plus ``:c`` Kahan companions and the ``__live__`` count),
    ``mask`` is the step's ``(n_shards, chunk)`` live mask on the
    device, and ``wids`` maps each window key to the step's host-side
    ``(n_shards, chunk)`` window ids.
    """

    def update(state, out, mask, wids):
        n_shards = mask.shape[0]
        fmask = mask.reshape(-1)
        new = {}
        for b in bindings:
            val = out[b.feature]
            val = val.reshape((-1,) + tuple(val.shape[2:]))
            contribs = b.red.update(val, fmask)
            for f in b.fields:
                key = _sk(b, f.name)
                part = _merged_segments(f.merge, contribs[f.name],
                                        wids[b.wkey], b.n_windows, n_shards)
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


class JobStepper:
    """One job as a resumable sequence of steps.

    ``start()`` binds the source, builds the step, opens the sink and
    restores committed state; ``step_once()`` runs one plan step and
    drains it into the sink (returning False when none remain);
    ``finish()`` finalizes windows and epoch aggregates; ``close()``
    releases source and sink and must run even when another method
    raised.
    """

    def __init__(self, m: DatasetManifest, p: DepamParams,
                 specs: list[FeatureSpec], source: Source, sink: Sink,
                 pl_: ShardPlan, use_kernels: bool,
                 max_steps: int | None = None,
                 window: Window | None = None,
                 compiler: Compiler | None = None,
                 device: torch.device = torch.device("cuda")):
        self.m = m
        self.p = p
        self.specs = tuple(specs)
        self.source = source
        self.sink = sink
        self.pl = pl_
        self.use_kernels = use_kernels
        self.max_steps = max_steps
        self.window = window
        self.compiler = compiler or DEFAULT_COMPILER
        self.device = torch.device(device)
        self._started = False
        self._closed = False
        self._result = None
        self._windows_out: dict[str, np.ndarray] = {}
        self._overflowed = False     # event-capacity warning fired once

    def start(self) -> "JobStepper":
        """Bind, build, open the sink, restore committed state.  A
        committed plan whose geometry differs from this job's wins, so a
        resume replays the exact logical layout it was written under."""
        committed = self.sink.committed_plan()
        if committed is not None:
            self.pl = partition_lib.adopt_plan(self.pl, committed)
        m, p, pl_ = self.m, self.p, self.pl
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
        self._step_fn = self.compiler.step(
            self.specs, m, p, self.use_kernels, source.device_synth,
            source.payload_dtype, self.device)
        self._agg_fn = self.compiler.reduce(bindings)

        self.sink.open(m, p, self._shapes, pl_)
        if self._windowed:
            self.sink.open_windows({
                b.out_name: (b.n_windows,) + tuple(b.red.out_shape(m, p))
                for b in self._windowed})
        if self._ragged:
            # capacity is a params knob, so every ragged feature of a
            # job shares p.event_capacity
            self.sink.open_events({
                name: (s.columns, p.event_capacity)
                for name, s in self._ragged.items()})
        start_step, resumed = self.sink.resume_state()
        if resumed is not None:
            prev_agg, prev_live = resumed
            q = prev_agg.pop("__quarantine__", None)
            if q is not None and np.asarray(q).size:
                raise ValueError(
                    f"cannot resume: the committed cursor carries "
                    f"{np.asarray(q).size} quarantined record(s), and "
                    f"bad-record tolerance is not ported yet; use a "
                    f"fresh store directory")
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
        self._stream = None if source.device_synth \
            else source.stream(pl_, start_step, self._n_steps)
        self._started = True
        return self

    @property
    def done(self) -> bool:
        return self._started and (self._result is not None
                                  or self._step >= self._n_steps)

    def step_once(self) -> bool:
        """Run one plan step and drain it into the sink; returns False
        when no step remains."""
        if not self._started:
            raise RuntimeError("JobStepper.step_once before start()")
        if self.done:
            return False
        step, dev = self._step, self.device
        idx = self.pl.step_indices(step)
        mask = self.pl.step_mask(step)
        dmask = torch.as_tensor(mask, device=dev)
        wids = {k: w.ids(idx, self.m) for k, w in self._wins.items()}
        if self.source.device_synth:
            out = self._step_fn(idx, dmask)
        else:
            payload = np.asarray(next(self._stream))
            if self._raw:
                if payload.dtype != np.int16:
                    raise TypeError(
                        f"int16 payload path got {payload.dtype} from "
                        f"{type(self.source).__name__}.stream — the "
                        f"source's payload_dtype promises raw '<i2' PCM")
                scales = torch.as_tensor(self.source.scales(idx),
                                         dtype=torch.float32, device=dev)
                out = self._step_fn(torch.as_tensor(payload, device=dev),
                                    dmask, scales)
            else:
                out = self._step_fn(
                    torch.as_tensor(payload.astype(np.float32, copy=False),
                                    device=dev), dmask)
        self._agg_state = self._agg_fn(self._agg_state, out, dmask, wids)
        self._drain(step, idx, mask, out)
        self._step += 1
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

    def _drain(self, step, idx, mask, out):
        """Copy one step's outputs to the host, write, and commit."""
        keep = mask.reshape(-1)
        sel = idx.reshape(-1)[keep]
        values = {name: out[name].cpu().numpy().reshape(
                      (-1,) + self._shapes[name])[keep]
                  for name in self._shapes}
        self.sink.write(step, sel, values)
        if self._ragged:
            self.sink.write_events(step, sel, self._compact(out, keep))
        if self.sink.wants_commit:
            # the carry in its NATIVE dtypes (float32 / int32): resume
            # casts losslessly, _finalize_rows widens to float64 itself
            agg_host = {k: v.cpu().numpy()
                        for k, v in self._agg_state.items()
                        if k != "__live__"}
            self._flush_closed(agg_host, self.pl.cursor_after(step))
            self.sink.commit(self.pl, step, agg_host,
                             float(self._agg_state["__live__"]))

    def _compact(self, out, keep):
        """Host-side compaction: the device returned fixed-capacity
        slabs; only the first min(count, capacity) rows of each live
        record enter the append-only log, in record order."""
        ev = {}
        for name in self._ragged:
            counts = out[name]["counts"].cpu().numpy().reshape(-1)[keep]
            rows = out[name]["rows"].cpu().numpy()
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
        """Finalize every window (trailing partial ones included) and the
        epoch aggregates; idempotent.  Returns (features, epoch, windows,
        window_edges, n_records, events, plan) — see job.JobResult;
        ``events`` is the sink's {name: EventLog} for ragged features
        (None when the job has none, or the sink streams)."""
        if not self._started:
            raise RuntimeError("JobStepper.finish before start()")
        if self._result is not None:
            return self._result
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
        self._result = (self.sink.result(), epoch, self._windows_out,
                        window_edges, int(host_state["__live__"]), events,
                        self.pl)
        return self._result

    def close(self):
        """Release stream, source and sink — all three, always; the first
        error re-raises after all three ran."""
        if self._closed:
            return
        self._closed = True
        first: BaseException | None = None
        stream = getattr(self, "_stream", None)
        for release in ((stream.close if stream is not None else None),
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
            max_steps: int | None, window: Window | None = None,
            device: torch.device = torch.device("cuda")):
    """Drive the job over plan ``pl_`` to completion; resumable when the
    sink is.  Returns (features, epoch, windows, window_edges,
    n_records, events, plan)."""
    return drive(JobStepper(m, p, specs, source, sink, pl_, use_kernels,
                            max_steps, window, device=device))


def drive(stepper: JobStepper):
    """Run one stepper start-to-finish with guaranteed cleanup."""
    try:
        stepper.start()
        while stepper.step_once():
            pass
        return stepper.finish()
    finally:
        stepper.close()
