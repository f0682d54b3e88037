"""Fair tenant schedulers for the soundscape service.

The service's scheduling problem is deliberately small: all tenants
share ONE device, a "turn" is a bounded quantum of plan steps, and the
scheduler only decides *whose* turn it is among the tenants that are
currently runnable (not finished, not blocked on a starved live
source).  Two policies:

  * :class:`RoundRobin` — strict cyclic order over runnable tenants.
    The starvation bound is immediate: between two consecutive turns of
    any tenant, every other runnable tenant gets exactly one turn, so
    no tenant ever falls more than one quantum behind per competitor.
  * :class:`DeficitRoundRobin` — weighted fairness via deficit
    counters (Shreedhar & Varghese): each replenish round grants every
    runnable tenant ``weight`` units of credit, the tenant with the
    largest credit runs, and the steps it actually executed are charged
    back.  Long-run step shares converge to the weight ratio while the
    per-round bound stays one quantum.

Schedulers are deliberately decoupled from tenant objects — they see
opaque ids plus a runnable set each turn, so the service can also use
them for admission or IO scheduling later.  They are not thread-safe on
their own; the service serializes calls under its own lock.
"""
from __future__ import annotations


class Scheduler:
    """Policy interface: ``add``/``remove`` maintain the tenant set,
    ``pick(runnable)`` chooses the next turn, ``charge(tid, steps)``
    reports what the turn actually consumed."""

    def add(self, tid: str, weight: float = 1.0) -> None:
        raise NotImplementedError

    def remove(self, tid: str) -> None:
        raise NotImplementedError

    def pick(self, runnable: list[str]) -> str:
        raise NotImplementedError

    def charge(self, tid: str, steps: int) -> None:
        pass


class RoundRobin(Scheduler):
    """Strict cyclic order over whatever subset is runnable."""

    def __init__(self):
        self._order: list[str] = []
        self._cursor = 0

    def add(self, tid, weight=1.0):
        if tid in self._order:
            raise ValueError(f"tenant {tid!r} already scheduled")
        self._order.append(tid)

    def remove(self, tid):
        i = self._order.index(tid)
        del self._order[i]
        if i < self._cursor:
            self._cursor -= 1
        if self._order:
            self._cursor %= len(self._order)

    def pick(self, runnable):
        if not runnable:
            raise ValueError("pick() with no runnable tenants")
        live = set(runnable)
        for off in range(len(self._order)):
            i = (self._cursor + off) % len(self._order)
            if self._order[i] in live:
                # next turn starts scanning AFTER the picked tenant —
                # that is the whole round-robin invariant
                self._cursor = (i + 1) % len(self._order)
                return self._order[i]
        raise ValueError(f"runnable tenants {sorted(live)} are not "
                         f"scheduled (have {self._order})")


class DeficitRoundRobin(Scheduler):
    """Deficit-weighted fairness: credit grants proportional to weight,
    actual step consumption charged back.

    ``pick`` replenishes lazily: when no runnable tenant has positive
    credit, every runnable one gains ``weight`` units (one "round").
    A tenant that was blocked keeps its earned credit, so a live tenant
    starved for a while catches up instead of losing its share.
    """

    def __init__(self):
        self._weights: dict[str, float] = {}
        self._credit: dict[str, float] = {}
        self._order: list[str] = []          # stable tie-break order

    def add(self, tid, weight=1.0):
        if tid in self._weights:
            raise ValueError(f"tenant {tid!r} already scheduled")
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        self._weights[tid] = float(weight)
        self._credit[tid] = 0.0
        self._order.append(tid)

    def remove(self, tid):
        del self._weights[tid]
        del self._credit[tid]
        self._order.remove(tid)

    def pick(self, runnable):
        if not runnable:
            raise ValueError("pick() with no runnable tenants")
        live = [t for t in self._order if t in set(runnable)]
        if not live:
            raise ValueError(f"runnable tenants {sorted(runnable)} are "
                             f"not scheduled (have {self._order})")
        if all(self._credit[t] <= 0 for t in live):
            for t in live:
                self._credit[t] += self._weights[t]
        # max credit wins; ties resolve in stable submission order
        return max(live, key=lambda t: (self._credit[t],
                                        -live.index(t)))

    def charge(self, tid, steps):
        if tid in self._credit:
            self._credit[tid] -= float(steps)
