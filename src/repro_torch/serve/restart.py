"""RestartPolicy — self-healing tenants for the SoundscapeService.

A tenant that dies of a *transient* cause (a starved live stream, an
exhausted IO retry budget) should not stay dead: because every commit
carries the engine's full resume lineage (carry, cursor, quarantine),
a fresh stepper built from the same job resumes from the last committed
cursor and the healed run is bitwise-identical to an uninterrupted one.

The policy is deliberately conservative:

  * only error *classes* the policy names are restartable — programming
    errors, integrity violations, and exceeded quarantine budgets fail
    the tenant immediately and loudly, exactly as without a policy;
  * the restart budget is bounded (``restarts`` re-admissions per
    tenant) so a persistently-broken tenant converges to ``failed``
    with its last error, never flaps forever;
  * re-admission waits out a capped exponential backoff with
    deterministic jitter (same scheme as
    :class:`~repro_torch.faults.retry.RetryPolicy`) — the tenant is *parked*,
    other tenants keep the device busy in the meantime.
"""
from __future__ import annotations

import dataclasses
import zlib

from repro_torch.faults.errors import (RetryExhausted, StreamStall,
                                       TransientError)

#: Error classes a default policy treats as transient tenant deaths.
DEFAULT_RESTARTABLE = (TransientError, StreamStall, RetryExhausted)


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounded re-admission of failed tenants from their committed
    cursor.

    ``restarts`` is the per-tenant budget of re-admissions (0 disables
    healing while keeping the accounting); ``retry_on`` the exception
    classes considered transient.  ``base_delay``/``max_delay`` shape
    the capped exponential backoff between death and re-admission, and
    ``jitter``/``seed`` add the same deterministic crc32-derived spread
    the IO-level :class:`~repro_torch.faults.retry.RetryPolicy` uses, so two
    services with one seed park and heal on identical clocks.
    """

    restarts: int = 2
    base_delay: float = 0.05
    max_delay: float = 5.0
    jitter: float = 0.5
    seed: int = 0
    retry_on: tuple = DEFAULT_RESTARTABLE

    def __post_init__(self):
        if self.restarts < 0:
            raise ValueError(
                f"restarts must be >= 0, got {self.restarts}")
        if self.base_delay < 0 or self.max_delay < self.base_delay:
            raise ValueError(
                f"need 0 <= base_delay <= max_delay, got "
                f"{self.base_delay}/{self.max_delay}")

    def restartable(self, error: BaseException) -> bool:
        """Is this tenant death transient under the policy?"""
        return isinstance(error, self.retry_on)

    def delay(self, restart: int) -> float:
        """Seconds to park before re-admission number ``restart``
        (0-based): capped exponential with deterministic jitter."""
        raw = min(self.base_delay * (2.0 ** restart), self.max_delay)
        frac = zlib.crc32(
            f"{self.seed}:{restart}".encode()) / 0xFFFFFFFF
        return raw * (1.0 + self.jitter * frac)
