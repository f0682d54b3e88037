"""The fluent SoundscapeJob builder — the one user-facing entry point.

::

    from repro_torch import api

    result = (api.job(manifest, params)
                 .features("welch", "spl", "tol", "ltsa")
                 .window(records=64)  # optional: reduction resolution
                 .source(reader)      # optional: default device synthesis
                 .to("/tmp/depam")    # optional: default in-memory
                 .chunk(8)
                 .payload("int16")    # optional: raw-PCM transport
                 .async_io(depth=2)   # optional: pipelined executor
                 .events(60.0, impulsive=True)  # optional: detection
                 .device("cuda")      # the default; "cpu" opts out
                 .run())

Every setter returns the job; ``run()`` validates the configuration
(incompatible source/knob combinations raise a ValueError naming the
conflict before any IO), builds one step over all selected features,
and drives the plan to completion (resuming if the sink supports it).
The job runs on the CUDA device unless ``.device("cpu")`` asks for the
CPU; without a CUDA device, the default raises instead of falling back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.manifest import DatasetManifest, ShardPlan, plan
from repro_torch.core.params import DepamParams
from repro_torch.device import resolve_device
from . import engine
from .features import EPOCH_WINDOW, FeatureSpec, Window, resolve_features
from .sinks import AsyncSink, Sink, as_sink
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
        self._device: str | torch.device = "cuda"
        self._exec = engine.ExecOptions()

    def features(self, *feats: str | FeatureSpec) -> "SoundscapeJob":
        """Select registered feature names and/or inline FeatureSpecs."""
        if not feats:
            raise ValueError("select at least one feature")
        self._features = list(feats)
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
        """Where the job runs: ``"cuda"`` (the default) or ``"cpu"``."""
        self._device = device
        return self

    def _plan(self) -> ShardPlan:
        return plan(self._m, 1, self._chunk)

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
        """Validate, wrap source and sink per the executor options, and
        build the resumable stepper this configuration describes."""
        device = resolve_device(self._device)
        specs = resolve_features(self._features)
        source: Source = as_source(self._source)
        self._validate(specs, source)
        if self._payload_dtype is not None:
            source = source.with_payload(self._payload_dtype)
        if self._exec.prefetch_depth > 0 and not source.device_synth \
                and not isinstance(source, PrefetchSource):
            source = PrefetchSource(source, depth=self._exec.prefetch_depth)
        sink: Sink = as_sink(self._sink)
        if self._exec.inflight > 0 and not isinstance(sink, AsyncSink):
            sink = AsyncSink(sink, queue_size=self._exec.queue_size)
        return engine.JobStepper(
            self._m, self._p, specs, source, sink, self._plan(),
            self._use_kernels, self._max_steps, self._exec,
            window=self._window, device=device)

    def run(self) -> JobResult:
        features, epoch, windows, edges, n_records, events, pl_ = \
            engine.drive(self._stepper())
        return JobResult(features=features, epoch=epoch, windows=windows,
                         window_edges=edges, n_records=n_records,
                         events=events, plan=pl_)


def job(manifest: DatasetManifest, params: DepamParams) -> SoundscapeJob:
    """Start a SoundscapeJob over ``manifest`` with ``params``."""
    return SoundscapeJob(manifest, params)
