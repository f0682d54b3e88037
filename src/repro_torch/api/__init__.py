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

::

    from repro_torch import api

    result = (api.job(manifest, params)
                 .features("welch", "spl", "tol")
                 .to("/tmp/depam")              # optional resumable store
                 .run())                        # on the CUDA device
    result["welch"], result["mean_welch"]
"""
from .features import (EPOCH_WINDOW, JOB_WINDOW, FeatureContext,
                       FeatureSpec, Reduction, StateField, Window,
                       feature_names, get_feature, mean_reduction, register,
                       resolve_features, unregister)
from .job import JobResult, SoundscapeJob, job
from .sinks import (CallbackSink, EventLog, MemorySink, Sink, StoreSink,
                    as_sink)
from .sources import ReaderSource, Source, SynthSource, WavSource, as_source

__all__ = [
    "FeatureContext", "FeatureSpec", "Reduction", "StateField", "Window",
    "EPOCH_WINDOW", "JOB_WINDOW", "mean_reduction",
    "feature_names", "get_feature", "register", "resolve_features",
    "unregister",
    "Source", "SynthSource", "ReaderSource", "WavSource", "as_source",
    "Sink", "MemorySink", "StoreSink", "CallbackSink", "EventLog",
    "as_sink",
    "SoundscapeJob", "JobResult", "job",
]
