"""The fault classes the port raises so far.

The reference's taxonomy (retryable transient errors, quarantinable bad
records, stalls, injected crashes) comes with the faults slice.  Until
then the port needs only what the feature store raises when a committed
artifact fails verification.

``FaultError``
    Base for every classified failure; carries ``fault`` (the taxonomy
    name) so an error that escapes to the user names the fault that
    caused it.
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


class StoreIntegrityError(FaultError):
    """A committed store artifact failed verification; names the file."""

    def __init__(self, message: str, *, fault: str = "store_integrity",
                 path: str | None = None):
        super().__init__(message, fault=fault)
        self.path = path
