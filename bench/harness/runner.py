"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one kind of traffic -- how records reach the
program, how its results leave it, what the window measures and what
the check compares -- is the mix's driver (``drivers/<name>.py``, named
by the mix's ``driver``).  This module does what every cell shares:

  * set-up, counted in ``setup_s``: the imports, the kernel library, the
    driver's inputs and job, the job's start and the mix's warm-up
    steps, which run the window's one step shape (with ``--trace 1``
    one more step, the profiler's own first);
  * the window, which the driver drives; the device memory peak over it
    and, traced, the profile of it and the program's own spans (where
    the program has a tracer, ``repro_torch.trace``);
  * the check, after the window has closed, the peak has been read and
    the program's state is freed;
  * the result line.  Nothing compiles inside the window.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time

import torch

from harness import check, discover, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver's ``build`` gets."""
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    p: object                   # repro_torch.core.params.DepamParams
    spans: trace.Spans


@dataclasses.dataclass
class Window:
    """What one measured window saw; the per-layer readers read this."""
    steps: int
    seconds: float
    host: dict                  # JobStepper.host_seconds over the window
    trace: trace.Summary | None
    kernel_costs: dict          # kernel function -> summed cost.Cost
    extra: dict                 # the driver's own readings
    program: trace.Program | None = None    # the program's spans, traced
    cards: tuple = ()           # a cell of several cards: their indices


def leaked_modules() -> list[str]:
    """Top-level names of forbidden modules loaded in this process."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def params(cfg: dict):
    """``DepamParams`` from every field of it that the configuration
    names, each cast to its default's type; the rest keep the default."""
    from repro_torch.core.params import DepamParams
    return DepamParams(**{f.name: type(f.default)(cfg[f.name])
                          for f in dataclasses.fields(DepamParams)
                          if f.name in cfg})


def program_tracer():
    """The program's tracer module, where it has one."""
    try:
        from repro_torch import trace as tracer
    except ImportError:
        return None
    return tracer if hasattr(tracer, "enable") else None


def card_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def job_cards(job) -> tuple[int, ...]:
    """The indices of the CUDA cards the job's executors run on."""
    return tuple(sorted({d.index for d in job.stepper.executors
                         if d.type == "cuda"}))


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_process: float | None = None,
        overrides: dict | None = None, fault=None,
        inspect: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``overrides`` replaces entries of the configuration and the mix (a
    rehearsal at a small size on the CPU, a rate of the knee sweep);
    ``fault`` is called with the driver's job before the window, to
    break the timed path in tests; ``inspect``, where given, receives
    the window and, where it asks with ``{"control": True}``, the
    control's numbers on the same sample.

    A cell of several chips (its ``chips`` in ``BENCHMARK.json``) reads
    every card its job runs on: each is synchronised and its peak reset
    at the window's start, the result's peak is the fullest card's, and
    the device block gives each card's peak and, traced, its busy and
    idle share.  A cell of one chip reads the current card alone."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = discover.benchmark()
    cellspec = discover.cell(spec, workload)
    cfg = dict(discover.config(spec, cellspec["config"]))
    mix = dict(discover.mix(cellspec["traffic"]))
    for k, v in (overrides or {}).items():
        (cfg if k in cfg and k not in mix else mix)[k] = v
    limits = discover.limits(workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cards = read = ()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_limit() if cuda else "cpu"

    from repro_torch.kernels import ops
    p = params(cfg)
    spans = trace.Spans(traced)
    kspans = trace.KernelSpans(spans, discover.costs(), p)
    tracer = program_tracer() if traced else None
    prof = None
    job = None
    try:
        if cuda:
            from repro_torch.kernels import _build
            _build.library()
        job = discover.driver(mix["driver"]).build(
            Context(cfg, mix, seed, dev, p, spans))
        if traced:
            kspans.install(ops)
        if fault is not None:
            fault(job)
        st = job.stepper
        st.start()
        job.warm(int(mix["warmup_steps"]))
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            if tracer is not None:
                tracer.enable()
            job.warm(1)             # the profiler's own first step
        if cellspec["chips"] > 1:
            cards = job_cards(job)
        read = cards or ((dev,) if cuda else ())
        for c in read:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        kspans.total.clear()
        host0 = dict(st.host_seconds)
        first = tracer.snapshot() if tracer is not None else None
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        got = job.window(t0, seconds)
        program = None if tracer is None \
            else trace.Program.between(first, tracer.snapshot())
        peaks = {c: torch.cuda.max_memory_allocated(c) for c in read}
        peak = max(peaks.values()) if peaks else None
        summary = program_block = None
        if prof is not None:
            done, prof = prof, None
            done.__exit__(None, None, None)
            names = tuple(kspans.costs)
            events = trace.raw_events(done, trace.HOST_SPANS + names)
            if program is not None:
                program_block = program.block(events)
            if cuda:
                summary = trace.summarize(events, set(names))
                if summary is None:
                    print(f"trace: no window to reduce "
                          f"{trace.census(events)}", file=sys.stderr)
        win = Window(steps=got["steps"], seconds=got["seconds"],
                     host={k: st.host_seconds[k] - host0[k] for k in host0},
                     trace=summary, kernel_costs=dict(kspans.total),
                     extra=got.get("extra", {}), program=program,
                     cards=cards)
        st.close()
        kspans.uninstall(ops)

        # -- the check, with the program's state freed --------------------
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = job.check(control=False)
        if inspect is not None:
            inspect["window"] = win
            if inspect.get("control"):
                inspect["control"] = job.check(control=True)
        correct = got["failed"] == 0 and check.verdict(numbers, limits)
        e2e = {"setup_s": setup_s,
               "peak_device_gib": None if peak is None else peak / 2 ** 30,
               **got["metrics"]}
        return result_line(spec, workload, traced, win, e2e, peaks, card,
                           numbers, limits, correct, got["attempted"],
                           got["failed"], program_block)
    finally:
        if tracer is not None:
            tracer.disable()
        if prof is not None:
            prof.__exit__(None, None, None)
        kspans.uninstall(ops)
        if job is not None:
            job.stepper.close()


def device_block(kind: str, peaks: dict, summary, cards: tuple) -> dict:
    """The result's ``device``: ``peaks`` maps each card read to its
    peak bytes over the window; ``summary`` is the traced window's, or
    None; ``cards``, where the cell spans several, adds each card's
    readings and makes ``busy_s`` their mean."""
    out = {"platform": "gpu", "kind": kind, "count": len(peaks),
           "memory_peak_bytes": int(max(peaks.values()))}
    busy = {c: summary.card_busy_s.get(c, 0.0) for c in cards} \
        if summary is not None else {}
    if summary is not None:
        out["busy_s"] = sum(busy.values()) / len(busy) if cards \
            else summary.busy_s
        out["window_s"] = summary.window_s
    if cards:
        out["cards"] = [
            {"index": c, "memory_peak_bytes": int(peaks[c]),
             **({"busy_s": busy[c],
                 "idle_pct": 100.0 * (1.0 - busy[c] / summary.window_s)}
                if summary is not None else {})} for c in cards]
    return out


def result_line(spec, workload, traced, win, e2e, peaks, card, numbers,
                limits, correct, attempted, failed,
                program_block=None) -> dict:
    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in discover.metrics_of(spec, workload, kind):
        value = discover.reader(m["name"])(win) if traced \
            else e2e.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics}
    if peaks:
        out["device"] = device_block(
            torch.cuda.get_device_name(next(iter(peaks))), peaks,
            win.trace if traced else None, win.cards)
    if traced and win.trace is not None:
        out["breakdown"] = trace.breakdown(win.trace)
    out["card"] = card
    out["setup_s"] = e2e["setup_s"]
    out["window"] = {"steps": win.steps, "seconds": win.seconds,
                     "host_s": win.host}
    if win.kernel_costs:
        out["roofline_bound"] = {k: v.bound
                                 for k, v in win.kernel_costs.items()}
    if program_block is not None:
        out["program_trace"] = program_block
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return out
