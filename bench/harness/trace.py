"""Spans, the profiled window, and the reduction of its trace.

The benchmark opens its own spans (``torch.profiler.record_function``)
around the calls it makes into each layer, and around the kernel
functions of ``repro_torch.kernels.ops`` that the step calls; nothing in
the program is edited.  With tracing off every span is a no-op.

From the trace of one window it takes:

  * the device operations (kernels, copies, fills) and the union of
    their intervals: ``busy_s`` over ``window_s``, over every card
    together and, by the card each ran on, ``card_busy_s``;
  * each kernel function's device time: every device operation whose
    launch is linked, through the profiler's correlation ids, to an op
    or span that lies inside that function's span on the host;
  * the idle intervals between device operations, each split by
    overlap over the innermost span open on the driving thread: the
    program's own spans (``repro_torch.trace``, each also a profiler
    range) and, inside ``job.dispatch``, the benchmark's kernel-function
    spans.

The traced window is the ``bench.window`` span on the driving thread:
the loop that dispatches the window's steps.

Where the program has a tracer, its spans over the window also reach
the readers as ``Program``: stamps on ``time.perf_counter_ns``, mapped
onto the profiler's clock through the clock pairs of the snapshots at
the window's start and end.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import re
import threading

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")      # CUDA runtime and driver calls
HOST_SPANS = (WINDOW_SPAN, "sink.enqueue")
NO_SPAN = "driver outside any span"


class Spans:
    """Span factory: ``span(name)`` is a profiler range when enabled, a
    no-op otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


class KernelSpans:
    """Wrap the kernel functions the step calls through the ``ops``
    module in spans of their own names, and add up the frozen cost of
    every outermost call (a function called from inside another, as the
    Welch PSD calls the per-frame PSD on paper set 2, belongs to the
    outer one)."""

    def __init__(self, spans: Spans, costs: dict, p):
        self.spans = spans
        self.costs = costs          # name -> fn(p, args, kwargs) -> Cost
        self.p = p
        self.total = {}             # name -> summed Cost
        self._depth = threading.local()
        self._saved = {}

    def install(self, module) -> None:
        for name, cost_of in self.costs.items():
            orig = getattr(module, name)
            self._saved[name] = orig
            setattr(module, name, self._wrap(name, orig, cost_of))

    def uninstall(self, module) -> None:
        for name, orig in self._saved.items():
            setattr(module, name, orig)
        self._saved = {}

    def _wrap(self, name, orig, cost_of):
        def call(*args, **kwargs):
            depth = getattr(self._depth, "n", 0)
            if depth:
                return orig(*args, **kwargs)
            self._depth.n = 1
            try:
                with self.spans.span(name):
                    out = orig(*args, **kwargs)
                c = cost_of(self.p, args, kwargs)
                self.total[name] = c if name not in self.total \
                    else self.total[name] + c
                return out
            finally:
                self._depth.n = 0
        return call


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    activity: str
    start: int          # ns
    end: int
    corr: int
    linked: int
    thread: int
    device: int = -1    # the card of a device operation


def _activity(e, span_names) -> str:
    """The event's kind, from ``activity_type`` where the profiler has
    it, else from its device, annotation flag, link and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    from torch.autograd import DeviceType
    name = e.name()
    ann = getattr(e, "is_user_annotation", None)
    ann = ann() if ann is not None else name in span_names
    if e.device_type() != DeviceType.CPU:
        if ann or name in span_names:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if ann:
        return "user_annotation"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def raw_events(prof, span_names=()) -> list[Event]:
    """The profiler's events as plain records (no parent tree).
    ``span_names``: the benchmark's span names, for a profiler that does
    not say which events are annotations."""
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append(Event(e.name(), _activity(e, set(span_names)),
                         e.start_ns(), e.end_ns(), e.correlation_id(),
                         e.linked_correlation_id(), e.start_thread_id(),
                         e.device_index()))
    return out


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    op_seconds: dict            # device op name -> seconds in the window
    span_device_s: dict         # kernel function -> device seconds
    idle_by_label: dict         # innermost driver span -> idle seconds
    window_ns: tuple            # the window's bounds, profiler clock
    busy_ns: list               # merged busy intervals [a, b] within it
    card_busy_s: dict = dataclasses.field(default_factory=dict)
    # card index -> seconds in which an operation ran on that card

    def idle_ns(self) -> list:
        """The window's intervals with no device operation, ascending."""
        gaps, prev = [], self.window_ns[0]
        for a, b in self.busy_ns + [[self.window_ns[1]] * 2]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        return gaps


@dataclasses.dataclass
class Program:
    """The program's own spans over one window: those begun between the
    tracer's snapshots at the window's start and end."""
    spans: list                 # repro_torch.trace.Span
    clocks: tuple               # (perf ns, profiler ns) at start, at end
    dropped: int                # spans the tracer could not keep

    @classmethod
    def between(cls, first, last) -> "Program":
        t0 = first.clocks[1][0]
        return cls([s for s in last.spans if s.start_ns >= t0],
                   (first.clocks[1], last.clocks[1]), last.dropped)

    def to_profiler(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` stamp on the profiler's clock (in whole
        ns: a float of Unix-epoch ns would round to 256)."""
        (p0, c0), (p1, c1) = self.clocks
        return c0 + (t_ns - p0) * (c1 - c0) // (p1 - p0)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def driver(self) -> int | None:
        """The thread that runs the job's steps."""
        steps = self.named("job.step")
        return steps[0].thread if steps else None

    def driver_spans(self) -> list:
        """The driving thread's spans as ``(start, end, name)`` on the
        profiler's clock."""
        d = self.driver()
        return [(self.to_profiler(s.start_ns), self.to_profiler(s.end_ns),
                 s.name) for s in self.spans if s.thread == d]

    @functools.cached_property
    def step_of(self) -> dict:
        """Span id -> the ``step`` of the ``job.step`` span that holds
        it, through the spans' parents."""
        by_id = {s.id: s for s in self.spans}
        out = {}
        for s in self.spans:
            top = s
            while top is not None and top.name != "job.step":
                top = by_id.get(top.parent)
            if top is not None:
                out[s.id] = top.attrs.get("step")
        return out

    def block(self, events: list[Event]) -> dict:
        """What the result line reports of the program's trace: the
        spans kept and dropped, the share of the window under
        ``job.step``, and the median and largest skew between a mapped
        driver span and its own range in the profiler's trace."""
        (p0, _), (p1, _) = self.clocks
        step_ns = sum(s.end_ns - s.start_ns for s in self.named("job.step"))
        skew = sorted(skew_us(self.driver_spans(), events) or [None])
        return {"kept": len(self.spans), "dropped": self.dropped,
                "job_step_pct": 100.0 * step_ns / (p1 - p0),
                "skew_us_median": skew[len(skew) // 2],
                "skew_us_max": skew[-1]}


def _union(intervals):
    busy, end, merged = 0, None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        busy += b - a
    return busy, merged


def segments(spans) -> list[tuple]:
    """Nested spans of one thread, ``(start, end, name)``, as disjoint
    segments ``(a, b, name)`` labelled by the innermost span open over
    each, ascending; time under no span gets no segment."""
    out, stack, t = [], [], None

    def close_to(limit):
        nonlocal t
        while stack and (limit is None or stack[-1][1] <= limit):
            _, end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for start, end, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_to(start)
        if stack and start > t:
            out.append((t, start, stack[-1][2]))
        t = start if t is None else max(t, start)
        stack.append((start, end, name))
    close_to(None)
    return out


def split(intervals, segs) -> collections.Counter:
    """Length of each disjoint, ascending interval ``(a, b)`` by the
    label of the segments it overlaps; the rest under ``NO_SPAN``."""
    out, j = collections.Counter(), 0
    for a, b in intervals:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(segs) and segs[k][0] < b:
            over = min(b, segs[k][1]) - max(a, segs[k][0])
            if over > 0:
                out[segs[k][2]] += over
                covered += over
            k += 1
        out[NO_SPAN] += (b - a) - covered
    return out


def skew_us(spans, events: list[Event]) -> list[float] | None:
    """For each driver span ``(start, end, name)`` mapped onto the
    profiler's clock, the distance in us from its start to the nearest
    start of a range of the same name on the profiler's driving thread
    (the thread of ``bench.window``); None without both."""
    win = [e for e in events if e.name == WINDOW_SPAN]
    if not win or not spans:
        return None
    starts = collections.defaultdict(list)
    for e in sorted(events, key=lambda e: e.start):
        if e.thread == win[0].thread and e.activity == "user_annotation":
            starts[e.name].append(e.start)
    out = []
    for start, _, name in spans:
        lst = starts.get(name, ())
        i = bisect.bisect_left(lst, start)
        near = [abs(lst[j] - start) for j in (i - 1, i)
                if 0 <= j < len(lst)]
        if near:
            out.append(min(near) / 1e3)
    return out or None


def census(events: list[Event]) -> dict:
    """Counts of a trace's events by kind, and of the benchmark's spans:
    what a run reports where it found no window to reduce."""
    kinds = collections.Counter(e.activity for e in events)
    spans = collections.Counter(e.name for e in events
                                if e.name in HOST_SPANS)
    return {"kinds": dict(kinds), "spans": dict(spans)}


def summarize(events: list[Event], kernel_names) -> Summary | None:
    """Reduce one window's events; None where the window is not found
    (tracing off) or no device operation ran in it."""
    host = [e for e in events if e.activity in ("cpu_op", "user_annotation")
            and e.linked == 0]
    win = [e for e in host if e.name == WINDOW_SPAN]
    if not win:
        return None
    ws, we = win[0].start, win[0].end
    driver = win[0].thread
    dev = [e for e in events if e.activity in DEVICE_ACTIVITIES
           and e.end > ws and e.start < we]
    if not dev:
        return None
    clipped = [(max(e.start, ws), min(e.end, we)) for e in dev]
    busy, merged = _union(clipped)
    by_card = collections.defaultdict(list)
    for e, iv in zip(dev, clipped):
        by_card[e.device].append(iv)

    op_s = collections.Counter()
    for e, (a, b) in zip(dev, clipped):
        op_s[e.name] += (b - a) / 1e9

    # kernel-function spans (outermost calls only, so they never overlap
    # on one thread), opened inside the window
    spans = collections.defaultdict(list)
    for e in host:
        if e.name in kernel_names and e.start >= ws:
            spans[e.thread].append((e.start, e.end, e.name))
    for v in spans.values():
        v.sort()
    everywhere = sorted(x for v in spans.values() for x in v)
    by_corr = {e.corr: e for e in host}
    # the CUDA runtime call that launched each device operation shares
    # its correlation id
    launched = {e.corr: e.start for e in events
                if e.activity in ("cuda_runtime", "cuda_driver")}

    def within(lst, t) -> str | None:
        i = bisect.bisect_right(lst, (t, float("inf"), "")) - 1
        if i >= 0 and lst[i][0] <= t <= lst[i][1]:
            return lst[i][2]
        return None

    def function_of(e: Event) -> str | None:
        """The kernel function whose span holds the launch of ``e``:
        through the op the profiler links it to, else (a launch from
        outside any op, as the port's kernels launch through ctypes)
        through the time of its runtime call."""
        h = by_corr.get(e.linked) if e.linked else None
        if h is not None:
            if h.name in kernel_names:
                return h.name if h.start >= ws else None
            return within(spans.get(h.thread, ()), h.start)
        t = launched.get(e.corr)
        return None if t is None else within(everywhere, t)

    span_s = collections.Counter()
    for e in dev:
        name = function_of(e)
        if name is not None:
            span_s[name] += (e.end - e.start) / 1e9

    out = Summary(window_s=(we - ws) / 1e9, busy_s=busy / 1e9,
                  device_ops=len(dev), op_seconds=dict(op_s),
                  span_device_s=dict(span_s), idle_by_label={},
                  window_ns=(ws, we), busy_ns=merged,
                  card_busy_s={c: _union(v)[0] / 1e9
                               for c, v in sorted(by_card.items())})
    # idle on the device by the innermost range open on the driving
    # thread, split by overlap (ranges on one thread nest)
    driver_spans = [(e.start, e.end, e.name) for e in host
                    if e.thread == driver and e.activity ==
                    "user_annotation" and e.name != WINDOW_SPAN]
    idle = split(out.idle_ns(), segments(driver_spans))
    out.idle_by_label = {k: v / 1e9 for k, v in idle.items() if v > 0}
    return out


def breakdown(s: Summary) -> dict:
    """The ten device operations with the most time, and the idle time
    by what the driving thread was doing."""
    ops = sorted(s.op_seconds.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(s.idle_by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
