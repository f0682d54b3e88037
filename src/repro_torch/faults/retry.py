"""Bounded retry with capped exponential backoff + deterministic jitter.

The paper's frameworks re-execute failed tasks a bounded number of
times (``spark.task.maxFailures``); this is that knob for the DEPAM
stack.  One :class:`RetryPolicy` instance is shared by every seam of a
job (source reads, sink writes, the speculative loader's last-resort
re-reads), so "how hard to try" is configured once.

Only :func:`~repro_torch.faults.errors.is_retryable` failures are retried —
bad records and exhausted budgets propagate immediately (retrying
corrupt data burns time and then fails anyway; retrying a retrier
multiplies budgets).  When the budget runs out the last error is
wrapped in :class:`~repro_torch.faults.errors.RetryExhausted`, which names
the underlying fault — the loud half of the invariant.

Jitter is deterministic (hashed from the policy seed and the attempt
number) so a replayed schedule sleeps the same wall-clock pattern; the
*results* never depend on it — retries re-run pure reads / idempotent
writes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib

from .errors import RetryExhausted, is_retryable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries; sleeps ``base_delay * 2^k`` capped at
    ``max_delay``, each stretched by up to ``jitter`` (fraction,
    deterministic) to decorrelate concurrent retriers."""

    attempts: int = 3
    base_delay: float = 0.01
    max_delay: float = 1.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")
        if self.base_delay < 0 or self.max_delay < 0 or self.jitter < 0:
            raise ValueError(f"negative delay/jitter in {self}")

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): capped
        exponential plus deterministic jitter."""
        base = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        h = zlib.crc32(f"{self.seed}:{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 + self.jitter * h)


class Retrier:
    """A policy plus its accounting: ``call`` runs a function under the
    policy, ``stats`` reports retries/exhaustions (the serve benchmark
    and ``JobResult`` surface them)."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self.retries = 0
        self.exhausted = 0

    def call(self, fn, *args):
        """Run ``fn(*args)``; retry retryable failures up to the
        policy's budget with backoff, then raise RetryExhausted
        chaining the last error."""
        p = self.policy
        last: BaseException | None = None
        for attempt in range(1, p.attempts + 1):
            try:
                return fn(*args)
            except BaseException as e:      # noqa: BLE001
                if not is_retryable(e):
                    raise
                last = e
                if attempt == p.attempts:
                    break
                with self._lock:
                    self.retries += 1
                time.sleep(p.delay(attempt))
        with self._lock:
            self.exhausted += 1
        raise RetryExhausted(
            f"retry budget exhausted after {p.attempts} attempts; last "
            f"failure (fault {getattr(last, 'fault', 'unknown')!r}): "
            f"{last}") from last

    def stats(self) -> dict:
        with self._lock:
            return {"retries": self.retries, "exhausted": self.exhausted,
                    "attempts": self.policy.attempts}
