"""The fault taxonomy — every named failure the stack can survive.

Spark's fault-tolerance story rests on a *classification*: a failed
task is retried only when the failure is attributable to the attempt
(executor lost, fetch failure) and not to the data; a corrupt split is
skipped (``spark.files.ignoreCorruptFiles``) only when the user opted
in; everything else fails the job loudly.  This module is that
classification for the DEPAM stack.  Every layer (loader, engine,
sinks, store, service) dispatches on these classes — never on message
strings — so the retry/quarantine/restart machinery composes without
guessing what an exception meant.

Classes
-------

``FaultError``
    Base for every *injected or classified* failure; carries ``fault``
    (the taxonomy name) so an error that escapes to the user names the
    fault that caused it — the "loud" half of the bitwise-or-loud
    invariant.
``TransientError``
    Failures attributable to the attempt, not the data: retrying the
    same operation may succeed (flaky NFS read, sink IO hiccup).  The
    only class the retry machinery ever retries.
``TransientReadError`` / ``SinkWriteError``
    Transient failures at the two IO seams (source reads, sink writes).
``BadRecordError``
    Failures attributable to the *data*: retrying cannot help
    (corrupt bytes, truncated file tail).  Quarantinable under
    ``.tolerate(bad_records=N)`` — never retried.
``CorruptRecordError`` / ``TruncatedRecordError``
    The two bad-record shapes.  ``TruncatedRecordError`` also
    subclasses ``ValueError`` so pre-existing callers catching the old
    truncated-read ValueError keep working.
``StreamStall``
    A live source's producer starved a blocking fetch.  Subclasses
    ``TimeoutError`` (the pre-classification type) and is *retryable at
    the tenant level*: the service parks the tenant and the
    :class:`~repro_torch.serve.restart.RestartPolicy` re-admits it,
    instead of the stall killing the tenant outright.
``RetryExhausted``
    The bounded retry budget ran out; chains the last transient error.
    Deliberately NOT transient itself — budgets do not nest.
``QuarantineExceeded``
    More bad records than ``.tolerate(bad_records=N)`` allowed.
``StoreIntegrityError``
    A committed store artifact (``agg-*.npz`` sidecar, event-log tail)
    failed its CRC32 — the store refuses to deserialize garbage and
    names the file instead.
``InjectedCrash``
    A :class:`~repro_torch.faults.plan.FaultPlan` crash point fired (process
    death simulation for the store's commit protocol).

``is_retryable(exc)`` / ``is_bad_record(exc)`` are the two predicates
the machinery uses; third-party errors can opt in by exposing a true
``retryable`` / ``bad_record`` attribute without subclassing.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class; ``fault`` is the taxonomy name of what went wrong."""

    def __init__(self, message: str, *, fault: str = "unknown",
                 record: int | None = None):
        super().__init__(message)
        self.fault = fault
        self.record = record


class TransientError(FaultError):
    """Attributable to the attempt — retrying may succeed."""

    retryable = True


class TransientReadError(TransientError):
    """A source read failed transiently (flaky disk/NFS/socket)."""

    def __init__(self, message: str, *, fault: str = "read_transient",
                 record: int | None = None):
        super().__init__(message, fault=fault, record=record)


class SinkWriteError(TransientError):
    """A sink write/commit failed transiently."""

    def __init__(self, message: str, *, fault: str = "sink_write"):
        super().__init__(message, fault=fault)


class BadRecordError(FaultError):
    """Attributable to the data — retrying cannot help; quarantinable."""

    bad_record = True


class CorruptRecordError(BadRecordError):
    """A record's bytes are garbage (failed decode/checksum)."""

    def __init__(self, message: str, *, fault: str = "record_corrupt",
                 record: int | None = None):
        super().__init__(message, fault=fault, record=record)


class TruncatedRecordError(BadRecordError, ValueError):
    """A file is shorter than the manifest says (truncated tail).

    Also a ValueError: the wav readers raised plain ValueError for this
    before the taxonomy existed, and callers catching that must keep
    working.
    """

    def __init__(self, message: str, *, fault: str = "record_truncated",
                 record: int | None = None):
        BadRecordError.__init__(self, message, fault=fault, record=record)


class StreamStall(TimeoutError):
    """A live source's blocking fetch starved waiting for its producer.

    Retryable at the TENANT level (park + restart policy), not at the
    read level — retrying the fetch immediately would just starve
    again.  Subclasses TimeoutError for pre-classification callers.
    """

    retryable = True
    fault = "live_stall"


class RetryExhausted(FaultError):
    """Bounded retry ran out of budget; chains the last attempt's error.

    Not transient: a retry budget is accounted once, at the seam that
    owns it — wrapping layers must fail loudly, not retry the retrier.
    """

    def __init__(self, message: str, *, fault: str = "retry_exhausted"):
        super().__init__(message, fault=fault)


class QuarantineExceeded(FaultError):
    """More bad records than ``.tolerate(bad_records=N)`` allowed."""

    def __init__(self, message: str, *, fault: str = "quarantine_budget"):
        super().__init__(message, fault=fault)


class StoreIntegrityError(FaultError):
    """A committed store artifact failed verification; names the file."""

    def __init__(self, message: str, *, fault: str = "store_integrity",
                 path: str | None = None):
        super().__init__(message, fault=fault)
        self.path = path


class InjectedCrash(FaultError):
    """A FaultPlan crash point fired (simulated process death)."""

    def __init__(self, site: str, *, fault: str = "crash"):
        super().__init__(
            f"injected crash (fault {fault!r}) at {site!r} — simulated "
            f"process death; a real crash here leaves exactly this "
            f"on-disk state", fault=fault)
        self.site = site


def is_retryable(exc: BaseException) -> bool:
    """True for failures a bounded retry may fix (attempt-attributable)."""
    return bool(getattr(exc, "retryable", False))


def is_bad_record(exc: BaseException) -> bool:
    """True for data-attributable failures (quarantinable, never
    retried)."""
    return bool(getattr(exc, "bad_record", False))
