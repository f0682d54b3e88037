"""The fluent SoundscapeJob builder — the one user-facing entry point.

::

    from repro_torch import api

    result = (api.job(manifest, params)
                 .features("welch", "spl", "tol", "ltsa")
                 .window(records=64)  # optional: reduction resolution
                 .shards(4)           # optional: logical partition
                 .on(mesh)            # optional: executors (launch.mesh)
                 .source(reader)      # optional: default device synthesis
                 .to("/tmp/depam")    # optional: default in-memory
                 .chunk(8)
                 .payload("int16")    # optional: raw-PCM transport
                 .async_io(depth=2)   # optional: pipelined executor
                 .events(60.0, impulsive=True)  # optional: detection
                 .retry(attempts=3)   # optional: bounded retry at IO
                 .tolerate(bad_records=2)  # optional: quarantine
                 .device("cuda")      # the default; "cpu" opts out
                 .run())

Every setter returns the job; ``run()`` validates the configuration
(incompatible source/knob combinations raise a ValueError naming the
conflict before any IO), builds one step over all selected features,
and drives the plan to completion (resuming if the sink supports it).
The job runs on the CUDA device unless ``.device("cpu")`` asks for the
CPU, or a mesh of CPU devices is given; without a CUDA device, the
default raises instead of falling back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.manifest import DatasetManifest, ShardPlan, plan
from repro_torch.core.params import DepamParams
from repro_torch.device import resolve_device
from repro_torch.distributed.partition import (build_partition,
                                               shard_sharding)
from repro_torch.faults.plan import FaultPlan
from repro_torch.faults.retry import Retrier, RetryPolicy
from . import engine
from .features import EPOCH_WINDOW, FeatureSpec, Window, resolve_features
from .sinks import AsyncSink, Sink, StoreSink, as_sink
from .sources import PrefetchSource, Source, as_source


@dataclasses.dataclass
class JobResult:
    """Outputs of one SoundscapeJob run.

      * ``features`` — feature name -> (n_records, *shape) per-record
        array (None for streaming sinks);
      * ``windows`` — reduction output -> (n_windows, *shape) windowed
        array, with ``window_edges[name]`` the (n_windows + 1,)
        record-offset boundaries;
      * ``epoch`` — whole-epoch aggregates such as ``mean_welch``;
      * ``events`` — ragged feature name -> ``sinks.EventLog``
        (per-record TRUE counts + kept rows); None when the job selects
        no ragged feature or the sink streams.

    ``quarantine`` is the bad-record accounting of a tolerant job
    (``.tolerate(bad_records=N)``): ``{"budget", "records", "reasons"}``
    — every quarantined record id with the fault that condemned it.
    None unless the job tolerates bad records; the engine also warns
    whenever the set is not empty.

    ``result[name]`` looks up all four; a name present in more than one
    namespace raises instead of silently preferring one.
    """

    features: dict[str, np.ndarray] | None
    epoch: dict[str, np.ndarray]
    windows: dict[str, np.ndarray]
    window_edges: dict[str, np.ndarray]
    n_records: int
    plan: ShardPlan
    events: dict | None = None
    quarantine: dict | None = None

    def __getitem__(self, name: str):
        spaces = [("features", self.features or {}),
                  ("epoch", self.epoch), ("windows", self.windows),
                  ("events", self.events or {})]
        hits = [(label, d[name]) for label, d in spaces if name in d]
        if len(hits) > 1:
            raise KeyError(
                f"{name!r} is ambiguous: present in "
                f"{' and '.join(label for label, _ in hits)}; read "
                f"result.<namespace>[{name!r}] explicitly")
        if hits:
            return hits[0][1]
        raise KeyError(
            f"{name!r} not in features {sorted(self.features or ())}, "
            f"epoch {sorted(self.epoch)}, windows "
            f"{sorted(self.windows)}, or events "
            f"{sorted(self.events or ())}")


class SoundscapeJob:
    """Builder for one pass of selected features over a manifest."""

    def __init__(self, manifest: DatasetManifest, params: DepamParams):
        self._m = manifest
        self._p = params
        self._features: list[str | FeatureSpec] = ["welch", "spl", "tol"]
        self._source = None
        self._sink = None
        self._chunk = 8
        self._use_kernels = True
        self._max_steps: int | None = None
        self._payload_dtype: str | None = None
        self._window: Window = EPOCH_WINDOW
        self._device: str | torch.device | None = None   # None: "cuda"
        self._exec = engine.ExecOptions()
        self._mesh = None
        self._data_axes: tuple[str, ...] = ("data",)
        self._shards: int | None = None
        self._fault_plan: FaultPlan | None = None
        self._retry: RetryPolicy | None = None
        self._tolerate: int | None = None

    def features(self, *feats: str | FeatureSpec) -> "SoundscapeJob":
        """Select registered feature names and/or inline FeatureSpecs."""
        if not feats:
            raise ValueError("select at least one feature")
        self._features = list(feats)
        return self

    def on(self, mesh, data_axes: tuple[str, ...] = ("data",)
           ) -> "SoundscapeJob":
        """Lay the job over ``data_axes`` of a mesh
        (``launch.mesh.make_host_mesh`` / ``device_mesh``): one executor
        per data coordinate, each owning its consecutive shard rows.
        None removes a previously-set mesh."""
        self._mesh = mesh
        self._data_axes = tuple(data_axes)
        return self

    def shards(self, n: int | None) -> "SoundscapeJob":
        """Fix the job's LOGICAL partition count independently of the
        mesh: the dataset is split into ``n`` contiguous worker slices
        (cut on file boundaries where the files allow — see
        ``distributed.partition.build_partition``), and the mesh's
        executors take ``n / D`` slices each.  Every array shape and
        reduction order is a function of ``n`` alone, so any executor
        count dividing ``n`` gives the same bits, fresh or resumed.
        Default (None): one slice per executor, or the interleaved
        single-slice plan without a mesh."""
        if n is not None and int(n) < 1:
            raise ValueError(f"shards must be >= 1, got {n}")
        self._shards = None if n is None else int(n)
        return self

    def source(self, src) -> "SoundscapeJob":
        """Where records come from: a Source, a reader callable, or None
        for on-device synthesis."""
        self._source = src
        return self

    def to(self, sink) -> "SoundscapeJob":
        """Where results go: Sink, FeatureStore, store path, or a
        streaming callback ``fn(step, indices, values)``."""
        self._sink = sink
        return self

    def chunk(self, records: int) -> "SoundscapeJob":
        """Records per step (the chunk size)."""
        if int(records) < 1:
            raise ValueError(f"chunk must be >= 1, got {records}")
        self._chunk = int(records)
        return self

    def window(self, records: int | None = None, *,
               per_file: bool = False) -> "SoundscapeJob":
        """Time resolution of the job's windowed reductions (``ltsa``,
        ``minmax``): ``records=N`` for fixed windows of N consecutive
        records, ``per_file=True`` for one window per manifest file,
        neither for the whole epoch as one window."""
        if records is not None and per_file:
            raise ValueError(
                "window(records=...) and window(per_file=True) are "
                "mutually exclusive — pick one resolution")
        if records is not None:
            self._window = Window("records", records=int(records))
        elif per_file:
            self._window = Window("file")
        else:
            self._window = EPOCH_WINDOW
        return self

    def kernels(self, enabled: bool) -> "SoundscapeJob":
        """Toggle the CUDA kernel path (True) vs the plain
        ``core.spectra`` path."""
        self._use_kernels = bool(enabled)
        return self

    def events(self, threshold_db: float | None = None, *,
               hysteresis_db: float | None = None,
               min_len: int | None = None,
               capacity: int | None = None,
               impulsive: bool = False) -> "SoundscapeJob":
        """Add loud-event detection to the job.

        Appends the ragged ``events`` feature (and the per-event
        ``impulsive`` metrics when ``impulsive=True``) to the selection
        and overrides the detection knobs on the job's params, where
        they live.  Omitted knobs keep the params' current values.
        """
        overrides = {k: v for k, v in (
            ("event_threshold_db", threshold_db),
            ("event_hysteresis_db", hysteresis_db),
            ("event_min_len", min_len),
            ("event_capacity", capacity)) if v is not None}
        if overrides:
            self._p = dataclasses.replace(self._p, **overrides)
        names = {s.name if isinstance(s, FeatureSpec) else s
                 for s in self._features}
        if "events" not in names:
            self._features.append("events")
        if impulsive and "impulsive" not in names:
            self._features.append("impulsive")
        return self

    def payload(self, dtype: str) -> "SoundscapeJob":
        """Host->device payload dtype for host-fed sources: ``"int16"``
        ships raw PCM (half the bus bytes) with a per-record decode-scale
        sidecar; results are bitwise-identical to ``"float32"``."""
        if dtype not in ("float32", "int16"):
            raise ValueError(
                f"payload dtype must be 'float32' or 'int16', "
                f"got {dtype!r}")
        self._payload_dtype = dtype
        return self

    def limit(self, max_steps: int | None) -> "SoundscapeJob":
        """Stop after ``max_steps`` plan steps (crash injection/tests)."""
        self._max_steps = max_steps
        return self

    def async_io(self, depth: int = 2, inflight: int = 2,
                 queue_size: int = 8) -> "SoundscapeJob":
        """Enable the pipelined executor: overlap host reads, device
        compute and sink IO.

        ``depth`` plan steps of host read-ahead (host-fed sources are
        wrapped in a :class:`PrefetchSource`), ``inflight`` device steps
        dispatched ahead of the sink drain (host<->device copies on
        their own CUDA streams through pinned buffers), and sink writes
        and commits moved onto an :class:`AsyncSink` writer bounded at
        ``queue_size`` steps.  Results are bitwise-identical to the
        synchronous path: pipelining reorders waiting, not computation.
        """
        self._exec = engine.ExecOptions(
            inflight=inflight, prefetch_depth=depth, queue_size=queue_size)
        return self

    def sync_io(self) -> "SoundscapeJob":
        """Back to the fully synchronous executor (the default)."""
        self._exec = engine.ExecOptions()
        return self

    def device(self, device: str | torch.device) -> "SoundscapeJob":
        """Where the job runs: ``"cuda"`` (the default) or ``"cpu"``.
        With a mesh, the mesh's devices decide; a device of another
        kind than the mesh's is refused."""
        self._device = device
        return self

    def retry(self, attempts: int = 3, *, base_delay: float = 0.01,
              max_delay: float = 1.0, jitter: float = 0.5,
              seed: int = 0) -> "SoundscapeJob":
        """Bounded retry for transient failures at the IO seams.

        One shared budget covers source reads and sink writes/commits:
        ``attempts`` tries per operation, capped exponential backoff
        from ``base_delay`` to ``max_delay`` with deterministic
        ``jitter``.  Only ``faults.is_retryable`` failures are retried;
        bad records propagate (or quarantine, see :meth:`tolerate`), and
        a failure on the device is never retried.  After the budget the
        job fails with a ``RetryExhausted`` naming the fault."""
        self._retry = RetryPolicy(attempts=attempts, base_delay=base_delay,
                                  max_delay=max_delay, jitter=jitter,
                                  seed=seed)
        return self

    def tolerate(self, *, bad_records: int) -> "SoundscapeJob":
        """Quarantine up to ``bad_records`` corrupt or truncated records
        instead of failing the job.  Quarantined records are masked out
        of every aggregate and never written per record; the set rides
        each commit (bitwise resume), ``JobResult.quarantine`` names
        every record and its fault, and a RuntimeWarning fires whenever
        the set is not empty.  One bad record past the budget raises
        ``QuarantineExceeded``."""
        if int(bad_records) < 0:
            raise ValueError(
                f"bad_records must be >= 0, got {bad_records}")
        self._tolerate = int(bad_records)
        return self

    def inject(self, plan_: FaultPlan | None) -> "SoundscapeJob":
        """Thread a deterministic ``faults.FaultPlan`` through every
        seam of this job (chaos testing): its read faults wrap the
        source, its sink faults wrap the sink, and its store crash
        points arm the feature store's commit protocol.  Any injected
        schedule either completes bitwise equal to the fault-free run or
        fails loudly naming the fault.  None removes a set plan."""
        self._fault_plan = plan_
        return self

    def _executors(self) -> tuple[torch.device, ...] | None:
        """The mesh's executors, checked against ``.device``: a mesh of
        another kind than an explicit device is refused, naming both."""
        if self._mesh is None:
            return None
        devs = shard_sharding(self._mesh, self._data_axes)
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"the mesh mixes device kinds {sorted(kinds)}")
        if self._device is not None:
            want = torch.device(self._device).type
            if want not in kinds:
                raise ValueError(
                    f".device({str(self._device)!r}) conflicts with the "
                    f"mesh of {kinds.pop()} devices given to .on(...): "
                    f"the job runs where its mesh is — drop .device(...) "
                    f"or build the mesh on {want} devices")
        for d in set(devs):
            resolve_device(d)
        return devs

    def _plan(self) -> ShardPlan:
        """The job's step plan.

        A single-slice job with no explicit ``.shards(...)`` keeps the
        interleaved :class:`ShardPlan` (existing stores resume against
        its cursor layout unchanged); any multi-executor or explicitly
        partitioned job gets a file-boundary-aware ``PartitionPlan``
        whose slice count L is fixed by ``.shards(L)`` (default: the
        mesh's executor count)."""
        devs = self._executors()
        n_dev = 1 if devs is None else len(devs)
        n_shards = self._shards if self._shards is not None else n_dev
        if n_dev > 1 and n_shards % n_dev:
            raise ValueError(
                f".shards({n_shards}) is not divisible by the mesh's "
                f"{n_dev} data-parallel devices — every device must own "
                f"the same number of worker slices")
        if n_shards == 1 and self._shards is None:
            return plan(self._m, 1, self._chunk)
        return build_partition(self._m, n_shards, self._chunk)

    def resume_step(self) -> int:
        """The plan step a run() would resume at (0 = from scratch)."""
        return as_sink(self._sink).committed_steps(self._plan())

    def _validate(self, specs: list[FeatureSpec], source: Source) -> None:
        """Reject incompatible source/knob combinations up front."""
        if self._payload_dtype == "int16" and source.device_synth:
            raise ValueError(
                ".payload('int16') conflicts with the device-synthesized "
                "source: synthesized records are regenerated on the "
                "device and never cross the host->device link — drop "
                ".payload(...) or feed the job from a reader "
                "(.source(...))")
        if self._window.kind == "file" and self._m.n_files == 0:
            raise ValueError(
                ".window(per_file=True) needs a manifest with files; "
                "this manifest has none")
        engine.resolve_bindings(specs, self._m, self._p, self._window)
        stored = {s.name for s in specs if s.shape is not None}
        for s in specs:
            for red in s.reductions:
                if red.out_name in stored:
                    raise ValueError(
                        f"reduction output {red.out_name!r} (from "
                        f"feature {s.name!r}) collides with the stored "
                        f"per-record feature of the same name — rename "
                        f"the reduction output")

    def _stepper(self) -> engine.JobStepper:
        """Validate, wrap source and sink per the executor and fault
        options, and build the resumable stepper this configuration
        describes."""
        devs = self._executors()
        device = devs[0] if devs is not None \
            else resolve_device(self._device or "cuda")
        pl_ = self._plan()
        specs = resolve_features(self._features)
        source: Source = as_source(self._source)
        self._validate(specs, source)
        if self._payload_dtype is not None:
            source = source.with_payload(self._payload_dtype)

        # fault machinery, innermost first, only when opted into — the
        # default path composes no extra layer:
        #   PrefetchSource(ResilientSource(FaultySource(inner)))
        #   AsyncSink(ResilientSink(FaultySink(inner)))
        faulted = self._fault_plan is not None
        resilient = faulted or self._retry is not None \
            or self._tolerate is not None
        quarantine = retrier = None
        if resilient:
            from repro_torch.faults.resilient import (
                FaultySink, FaultySource, Quarantine, ResilientSink,
                ResilientSource)
            retrier = Retrier(self._retry or RetryPolicy())
            if self._tolerate is not None:
                quarantine = Quarantine(self._tolerate)
            fp = self._fault_plan
            inject_reads = faulted and any(
                s.site == "source.fetch" for s in fp.specs)
            inject_sink = faulted and any(
                s.site in ("sink.write", "sink.commit") for s in fp.specs)
            if not source.device_synth:
                if inject_reads:
                    source = FaultySource(source, fp)
                source = ResilientSource(source, retrier=retrier,
                                         quarantine=quarantine)
        if self._exec.prefetch_depth > 0 and not source.device_synth \
                and not isinstance(source, PrefetchSource):
            source = PrefetchSource(source, depth=self._exec.prefetch_depth)
        sink: Sink = as_sink(self._sink)
        if faulted and isinstance(sink, StoreSink):
            # arm the store's commit-protocol crash points
            sink.store.faults = self._fault_plan
        if resilient:
            if inject_sink:
                sink = FaultySink(sink, self._fault_plan)
            sink = ResilientSink(sink, retrier)
        if self._exec.inflight > 0 and not isinstance(sink, AsyncSink):
            sink = AsyncSink(sink, queue_size=self._exec.queue_size)
        return engine.JobStepper(
            self._m, self._p, specs, source, sink, pl_,
            self._use_kernels, self._max_steps, self._exec,
            window=self._window, device=device, mesh=self._mesh,
            data_axes=self._data_axes, quarantine=quarantine)

    def run(self) -> JobResult:
        features, epoch, windows, edges, n_records, events, pl_, quar = \
            engine.drive(self._stepper())
        return JobResult(features=features, epoch=epoch, windows=windows,
                         window_edges=edges, n_records=n_records,
                         events=events, plan=pl_, quarantine=quar)


def job(manifest: DatasetManifest, params: DepamParams) -> SoundscapeJob:
    """Start a SoundscapeJob over ``manifest`` with ``params``."""
    return SoundscapeJob(manifest, params)
