"""The fault classes the port raises so far.

The rest of the reference's taxonomy (stalls, injected crashes, retry
budgets) comes with the faults slice.  Until then the port needs what
the feature store raises when a committed artifact fails verification,
what the wav readers raise on a short file, and the transient classes
and predicates the prefetching loader retries by.

``FaultError``
    Base for every classified failure; carries ``fault`` (the taxonomy
    name) so an error that escapes to the user names the fault that
    caused it.
``TransientError``
    Attributable to the attempt, not the data: retrying the same
    operation may succeed.  The only class a retry ever retries.
``TransientReadError`` / ``SinkWriteError``
    Transient failures at the two IO seams (source reads, sink writes).
``BadRecordError``
    Attributable to the data (``bad_record = True``): retrying cannot
    help.
``TruncatedRecordError``
    A wav file is shorter than the manifest says; also a ValueError.
``StoreIntegrityError``
    A committed store artifact (``agg-*.npz`` sidecar, event-log
    prefix) failed its CRC32
    — the store refuses to deserialize garbage and names the file
    instead.

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


class TruncatedRecordError(BadRecordError, ValueError):
    """A file is shorter than the manifest says (truncated tail).

    Also a ValueError: the wav readers raised plain ValueError for this
    before the taxonomy existed, and callers catching that must keep
    working.
    """

    def __init__(self, message: str, *, fault: str = "record_truncated",
                 record: int | None = None):
        BadRecordError.__init__(self, message, fault=fault, record=record)


class StoreIntegrityError(FaultError):
    """A committed store artifact failed verification; names the file."""

    def __init__(self, message: str, *, fault: str = "store_integrity",
                 path: str | None = None):
        super().__init__(message, fault=fault)
        self.path = path


def is_retryable(exc: BaseException) -> bool:
    """True for failures a bounded retry may fix (attempt-attributable)."""
    return bool(getattr(exc, "retryable", False))


def is_bad_record(exc: BaseException) -> bool:
    """True for data-attributable failures (quarantinable, never
    retried)."""
    return bool(getattr(exc, "bad_record", False))
