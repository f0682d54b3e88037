"""Declarative SoundscapeJob API — the user-facing surface of the port.

Three axes compose freely:

  * **features** — a registry of :class:`FeatureSpec` (welch, spl, tol,
    ltsa, minmax, yours), all computed in one step per chunk from one
    shared Welch PSD;
  * **sources** — device-synthesized (:class:`SynthSource`) or any host
    callback (:class:`ReaderSource`), float32 or raw int16 PCM;
  * **sinks** — in-memory (:class:`MemorySink`), the resumable feature
    store (:class:`StoreSink`), or a streaming callback
    (:class:`CallbackSink`).

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
from .sinks import CallbackSink, MemorySink, Sink, StoreSink, as_sink
from .sources import ReaderSource, Source, SynthSource, as_source

__all__ = [
    "FeatureContext", "FeatureSpec", "Reduction", "StateField", "Window",
    "EPOCH_WINDOW", "JOB_WINDOW", "mean_reduction",
    "feature_names", "get_feature", "register", "resolve_features",
    "unregister",
    "Source", "SynthSource", "ReaderSource", "as_source",
    "Sink", "MemorySink", "StoreSink", "CallbackSink", "as_sink",
    "SoundscapeJob", "JobResult", "job",
]
