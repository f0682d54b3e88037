"""The fault classes the port raises so far.

The reference's taxonomy (retryable transient errors, stalls, injected
crashes, retry budgets) comes with the faults slice.  Until then the
port needs what the feature store raises when a committed artifact
fails verification, and what the wav readers raise on a short file.

``FaultError``
    Base for every classified failure; carries ``fault`` (the taxonomy
    name) so an error that escapes to the user names the fault that
    caused it.
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
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class; ``fault`` is the taxonomy name of what went wrong."""

    def __init__(self, message: str, *, fault: str = "unknown",
                 record: int | None = None):
        super().__init__(message)
        self.fault = fault
        self.record = record


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
