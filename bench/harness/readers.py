"""Arithmetic the per-layer metric readers share.  A reader returns None
where its window has nothing to read; the harness then leaves the metric
out of the result line."""
from __future__ import annotations

import numpy as np

from harness import trace


def per_step_ms(win, seconds: float) -> float | None:
    return None if win.steps == 0 else seconds / win.steps * 1e3


def host_ms_per_step(win, *phases: str) -> float | None:
    """Driver-thread seconds in ``JobStepper.host_seconds`` phases over
    the window, per step."""
    return per_step_ms(win, sum(win.host[p] for p in phases))


def roofline_pct(win, function: str) -> float | None:
    """The frozen cost's least time for the window's calls of a kernel
    function over the device time of what those calls launched."""
    c = win.kernel_costs.get(function)
    if c is None or win.trace is None:
        return None
    device_s = win.trace.span_device_s.get(function, 0.0)
    return None if device_s <= 0 else 100.0 * c.bound_s / device_s


def idle_pct(win) -> float | None:
    """Share of the traced window in which no kernel, copy or fill ran
    on the device."""
    if win.trace is None or win.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)


def device_ops_per_step(win) -> float | None:
    if win.trace is None or win.steps == 0:
        return None
    return win.trace.device_ops / win.steps


# -- the program's own spans (Window.program) ------------------------------
# Each returns None where the window has no program spans, where the
# tracer dropped any, or where no step ran.

def program(win):
    p = win.program
    if p is None or p.dropped or not p.named("job.step"):
        return None
    return p


def span_ms_per_step(win, name: str, driver: bool = True,
                     early: bool | None = None) -> float | None:
    """Summed ms of the spans ``name`` on the driving thread (or, with
    ``driver=False``, on every other thread) over the window's steps;
    with ``early`` only ``source.copy`` spans whose attribute says so."""
    p = program(win)
    if p is None:
        return None
    d = p.driver()
    ns = sum(s.end_ns - s.start_ns for s in p.named(name)
             if (s.thread == d) == driver
             and (early is None or s.attrs.get("early") == early))
    return ns / 1e6 / len(p.named("job.step"))


def _ready_waits(p) -> dict:
    """Step -> its last ``source.wait`` that carries ``ready_ns``: the
    push stamp of the step's last arrival."""
    out = {}
    for s in p.named("source.wait"):
        step = p.step_of.get(s.id)
        if "ready_ns" in s.attrs and step is not None \
                and (step not in out or s.end_ns > out[step].end_ns):
            out[step] = s
    return out


def _p95(values) -> float | None:
    return float(np.percentile(values, 95)) if values else None


def ready_to_sink_ms_p95(win) -> float | None:
    """95th percentile over the window's steps of the time from the
    step's last arrival to the end of its ``job.drain``."""
    p = program(win)
    if p is None:
        return None
    waits = _ready_waits(p)
    return _p95([(d.end_ns - waits[d.attrs["step"]].attrs["ready_ns"]) / 1e6
                 for d in p.named("job.drain")
                 if d.attrs.get("step") in waits])


def fetch_lag_ms_p95(win) -> float | None:
    """95th percentile over the window's steps of the time from the
    step's last arrival to the end of the fetch's wait for it."""
    p = program(win)
    if p is None:
        return None
    return _p95([(w.end_ns - w.attrs["ready_ns"]) / 1e6
                 for w in _ready_waits(p).values()])


def early_copy_pct(win) -> float | None:
    """Share of the records copied out of the ring while a record of
    the same step was still to land."""
    p = program(win)
    if p is None:
        return None
    copies = p.named("source.copy")
    total = sum(s.attrs["records"] for s in copies)
    early = sum(s.attrs["records"] for s in copies if s.attrs["early"])
    return None if total == 0 else 100.0 * early / total


def host_bound_idle_pct(win) -> float | None:
    """Share of the traced window in which the device is idle and the
    driving thread's innermost program span is not ``source.wait``: the
    device waits on the host's work, not on arrivals.  Each idle
    interval is split by overlap over the mapped driver spans."""
    p = program(win)
    if p is None or win.trace is None:
        return None
    s = win.trace
    idle = trace.split(s.idle_ns(), trace.segments(p.driver_spans()))
    waiting = idle.get("source.wait", 0)
    ws, we = s.window_ns
    return 100.0 * (sum(idle.values()) - waiting) / (we - ws)
