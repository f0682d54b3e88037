"""Declarative SoundscapeJob API — the user-facing surface of the port.

Three axes compose freely:

  * **features** — a registry of :class:`FeatureSpec` (welch, spl, tol,
    ltsa, minmax, percentiles, spd, the ragged events/impulsive, yours),
    all computed in one step per chunk from shared Welch / per-frame
    PSD intermediates;
  * **sources** — device-synthesized (:class:`SynthSource`), any host
    callback (:class:`ReaderSource`) or a wav directory
    (:class:`WavSource`), float32 or raw int16 PCM;
  * **sinks** — in-memory (:class:`MemorySink`), the resumable feature
    store (:class:`StoreSink`), or a streaming callback
    (:class:`CallbackSink`); ragged outputs arrive as
    :class:`EventLog` values.

Execution is synchronous by default; ``.async_io(depth=2)`` switches to
the pipelined executor (:class:`ExecOptions`) — host reads prefetched
through the speculative loader (:class:`PrefetchSource`), host<->device
copies on their own CUDA streams through pinned buffers, up to
``inflight`` steps dispatched ahead, and sink IO on an
:class:`AsyncSink` background writer — with bitwise-identical results.

``.shards(L)`` fixes a file-aligned partition of L logical slices and
``.on(mesh)`` lays it over the executors of a host mesh
(``repro_torch.launch.mesh``), with the same bits at every executor
count dividing L.  ``.retry()``, ``.tolerate(bad_records=N)`` and
``.inject(FaultPlan)`` add the fault layer (``repro_torch.faults``).

::

    from repro_torch import api

    result = (api.job(manifest, params)
                 .features("welch", "spl", "tol")
                 .to("/tmp/depam")              # optional resumable store
                 .async_io()                    # optional pipelining
                 .run())                        # on the CUDA device
    result["welch"], result["mean_welch"]
"""
from .engine import ExecOptions
from .features import (EPOCH_WINDOW, JOB_WINDOW, FeatureContext,
                       FeatureSpec, Reduction, StateField, Window,
                       SPD_DB_MAX, SPD_DB_MIN, SPD_DB_STEP, SPD_N_DB,
                       SPECTRUM_PERCENTILES, EVENT_COLUMNS,
                       IMPULSIVE_COLUMNS, feature_names, get_feature,
                       mean_reduction, register, resolve_features,
                       unregister)
from .sources import (PrefetchSource, ReaderSource, Source, SynthSource,
                      WavSource, as_source)
from repro_torch.data.wavio import scan_dataset
from repro_torch.meta import (Instrument, TimestampParseError, format_utc,
                              parse_timestamp, timestamps_for)
from .sinks import (AsyncSink, CallbackSink, EventLog, MemorySink, Sink,
                    StoreSink, as_sink)
from .job import JobResult, SoundscapeJob, job
from repro_torch.faults import FaultPlan, FaultSpec, RetryPolicy

__all__ = [
    "ExecOptions",
    "FeatureContext", "FeatureSpec", "Reduction", "StateField", "Window",
    "EPOCH_WINDOW", "JOB_WINDOW", "mean_reduction",
    "SPD_DB_MAX", "SPD_DB_MIN", "SPD_DB_STEP", "SPD_N_DB",
    "SPECTRUM_PERCENTILES", "EVENT_COLUMNS", "IMPULSIVE_COLUMNS",
    "feature_names", "get_feature", "register",
    "resolve_features", "unregister",
    "Source", "SynthSource", "ReaderSource", "WavSource", "PrefetchSource",
    "as_source", "scan_dataset",
    "Sink", "MemorySink", "StoreSink", "CallbackSink", "AsyncSink",
    "EventLog", "as_sink",
    "Instrument", "TimestampParseError", "format_utc",
    "parse_timestamp", "timestamps_for",
    "SoundscapeJob", "JobResult", "job",
    "FaultPlan", "FaultSpec", "RetryPolicy",
]
