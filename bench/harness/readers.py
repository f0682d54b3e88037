"""Arithmetic the per-layer metric readers share.  A reader returns None
where its window has nothing to read; the harness then leaves the metric
out of the result line."""
from __future__ import annotations


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
