"""The port's tracer: named spans kept in memory, off by default.

A span records where the program does one piece of work: its name, the
thread, its start and end on ``time.perf_counter_ns``, the span open on
the same thread when it began (its parent) and its attributes.  Spans
are kept in a bounded buffer; what does not fit is counted, not kept.
While a span is open it is also a ``torch.profiler.record_function``
range, so spans on the profiler's thread land in the device trace.

Off (the default) ``span`` returns one shared no-op context and
``begin`` and ``end`` return at once: a span site costs the check of
the module global ``active``.

``snapshot`` returns the spans and two clock pairs, one
taken at ``enable`` and one at the snapshot.  Each pair is
``(perf_counter ns, profiler clock ns)``, the profiler clock read just
before and just after the ``perf_counter`` read; the two pairs map any
span stamp, from any thread, linearly onto the device trace's clock.
torch's profiler stamps its events in Unix-epoch nanoseconds (its
approximate clock, converted to the wall clock), so the profiler clock
here is ``time.time_ns``.

A phase that a caller already times (``JobStepper.host_seconds``) hands
its own clock reads to ``begin`` and ``end``, so one read feeds both.
A span that an exception leaves open is closed by the enclosing span's
exit.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

import torch

active = False              # read at every span site
CAPACITY = 1 << 16          # spans a trace keeps

profiler_clock_ns = time.time_ns

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_session = 0                # bumped by enable: stacks of an older one go
_spans: list = []
_dropped = 0
_clock0: tuple = (0, 0)


class Span(NamedTuple):
    id: int
    parent: int | None      # the span open on the same thread at start
    name: str
    thread: int             # threading.get_ident()
    start_ns: int           # time.perf_counter_ns
    end_ns: int
    attrs: dict


@dataclasses.dataclass
class Snapshot:
    spans: list             # [Span], in the order they closed
    clocks: tuple           # ((perf ns, profiler ns) at enable, at snapshot)
    dropped: int            # spans that did not fit in the buffer


class _Off:
    """The context every span site gets while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


class _Open:
    """A span being recorded; as a context it reads the clock itself."""
    __slots__ = ("name", "attrs", "id", "parent", "start", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs):
        """Add attributes known only once the span is under way."""
        self.attrs.update(attrs)

    def __enter__(self):
        _push(self, None)
        return self

    def __exit__(self, *exc):
        _pop_to(self, time.perf_counter_ns())
        return False


def _stack() -> list:
    if getattr(_local, "session", None) != _session:
        _local.session, _local.stack = _session, []
    return _local.stack


def _push(s: _Open, t_ns: int | None) -> None:
    stack = _stack()
    s.id = next(_ids)
    s.parent = stack[-1].id if stack else None
    stack.append(s)
    s._range = torch.profiler.record_function(s.name)
    s._range.__enter__()
    # read after the profiler's own stamp, as the close reads before
    s.start = time.perf_counter_ns() if t_ns is None else t_ns


def _close(s: _Open, t_ns: int) -> None:
    global _dropped
    s._range.__exit__(None, None, None)
    rec = Span(s.id, s.parent, s.name, threading.get_ident(), s.start,
               t_ns, s.attrs)
    with _lock:
        if len(_spans) < CAPACITY:
            _spans.append(rec)
        else:
            _dropped += 1


def _pop_to(s: _Open, t_ns: int) -> None:
    stack = _stack()
    if s not in stack:          # opened before the last enable: not kept
        s._range.__exit__(None, None, None)
        return
    while stack:
        top = stack.pop()
        _close(top, t_ns)
        if top is s:
            return


def span(name: str, **attrs):
    """A context that records one span; the shared no-op when off."""
    if not active:
        return OFF
    return _Open(name, attrs)


def begin(name: str, t_ns: int | None = None, **attrs) -> None:
    """Open a span at ``t_ns`` (now if None) on this thread; ``end``
    closes it.  For a phase whose bounds the caller reads anyway."""
    if not active:
        return
    _push(_Open(name, attrs), t_ns)


def end(t_ns: int | None = None, **attrs) -> None:
    """Close the innermost span this thread opened with ``begin``,
    adding ``attrs`` to it."""
    if not active:
        return
    stack = _stack()
    if stack:
        s = stack.pop()
        s.attrs.update(attrs)
        _close(s, time.perf_counter_ns() if t_ns is None else t_ns)


def clock_pair() -> tuple[int, int]:
    """``(perf_counter ns, profiler clock ns)`` read at one moment: of
    five brackets of a ``perf_counter`` read between two profiler clock
    reads, the tightest, at its midpoint."""
    best = None
    for _ in range(5):
        a = profiler_clock_ns()
        p = time.perf_counter_ns()
        b = profiler_clock_ns()
        if best is None or b - a < best[0]:
            best = (b - a, p, (a + b) // 2)
    return best[1], best[2]


def enable() -> None:
    """Start a fresh trace of at most ``CAPACITY`` spans."""
    global active, _spans, _dropped, _clock0, _session
    with _lock:
        _session += 1
        _spans, _dropped = [], 0
        _clock0 = clock_pair()
        active = True


def disable() -> None:
    """Stop recording; what was recorded stays for ``snapshot``."""
    global active
    active = False


def snapshot() -> Snapshot:
    with _lock:
        return Snapshot(list(_spans), (_clock0, clock_pair()), _dropped)
