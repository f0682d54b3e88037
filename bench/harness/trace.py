"""Spans, the profiled window, and the reduction of its trace.

The benchmark opens its own spans (``torch.profiler.record_function``)
around the calls it makes into each layer, and around the kernel
functions of ``repro_torch.kernels.ops`` that the step calls; nothing in
the program is edited.  With tracing off every span is a no-op.

From the trace of one window it takes:

  * the device operations (kernels, copies, fills) and the union of
    their intervals: ``busy_s`` over ``window_s``;
  * each kernel function's device time: every device operation whose
    launch is linked, through the profiler's correlation ids, to an op
    or span that lies inside that function's span on the host;
  * the idle gaps between device operations, each labelled by the
    innermost benchmark span open on the driving thread at the gap.

The traced window is the ``bench.window`` span on the driving thread:
the loop that dispatches the window's steps.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re
import threading

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")      # CUDA runtime and driver calls
HOST_SPANS = (WINDOW_SPAN, "step_once", "sink.enqueue")


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
                         e.linked_correlation_id(), e.start_thread_id()))
    return out


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    op_seconds: dict            # device op name -> seconds in the window
    span_device_s: dict         # kernel function -> device seconds
    idle_by_label: dict         # host span -> idle seconds
    idle_gaps: int


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

    # idle gaps on the device, each labelled by the innermost span open
    # on the driving thread at its midpoint (spans on one thread nest)
    driver_spans = sorted((e.start, e.end, e.name) for e in host
                          if e.thread == driver and e.activity ==
                          "user_annotation" and e.name != WINDOW_SPAN)
    gaps, prev = [], ws
    for a, b in merged + [[we, we]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = collections.Counter()
    stack, k = [], 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(driver_spans) and driver_spans[k][0] <= mid:
            while stack and stack[-1][1] < driver_spans[k][0]:
                stack.pop()
            stack.append(driver_spans[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "driver outside step_once"
        idle[label] += (b - a) / 1e9
    return Summary(window_s=(we - ws) / 1e9, busy_s=busy / 1e9,
                   device_ops=len(dev), op_seconds=dict(op_s),
                   span_device_s=dict(span_s), idle_by_label=dict(idle),
                   idle_gaps=len(gaps))


def breakdown(s: Summary) -> dict:
    """The ten device operations with the most time, and the idle time
    by what the driving thread was doing."""
    ops = sorted(s.op_seconds.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(s.idle_by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
