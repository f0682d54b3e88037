"""Fault tolerance: deterministic injection, retry, quarantine, integrity.

The subsystem behind the bitwise-or-loud invariant: under any injected
fault schedule, a run either completes bitwise-identical to the
fault-free run, or fails loudly with an error naming the fault — never
a silent wrong answer.  The counterpart of the reference's ``faults``
package: ``errors`` (the taxonomy), ``plan`` (deterministic schedules),
``retry`` (bounded retry) and ``resilient`` (the Source/Sink wrappers
and the quarantine).
"""
from .errors import (BadRecordError, CorruptRecordError, FaultError,
                     InjectedCrash, QuarantineExceeded, RetryExhausted,
                     SinkWriteError, StoreIntegrityError, StreamStall,
                     TransientError, TransientReadError,
                     TruncatedRecordError, is_bad_record, is_retryable)
from .plan import KINDS, FaultPlan, FaultSpec
from .retry import Retrier, RetryPolicy

# The wrappers subclass Source/Sink from repro_torch.api, which itself pulls
# in layers (engine, store) that import THIS package's error taxonomy —
# resolve them lazily (PEP 562) so `from repro_torch.faults.errors import ...`
# works from anywhere in the stack without an import cycle.
_RESILIENT = ("FaultySink", "FaultySource", "Quarantine",
              "ResilientSink", "ResilientSource")


def __getattr__(name):
    if name in _RESILIENT:
        from . import resilient
        return getattr(resilient, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BadRecordError", "CorruptRecordError", "FaultError", "FaultPlan",
    "FaultSpec", "FaultySink", "FaultySource", "InjectedCrash", "KINDS",
    "Quarantine", "QuarantineExceeded", "ResilientSink",
    "ResilientSource", "Retrier", "RetryExhausted", "RetryPolicy",
    "SinkWriteError", "StoreIntegrityError", "StreamStall",
    "TransientError", "TransientReadError", "TruncatedRecordError",
    "is_bad_record", "is_retryable",
]
