"""The readers of the program's own spans (``repro_torch.trace``) on a
hand-built trace with known stamps, the overlap split that labels the
device's idle time, and the traced rehearsal on the CPU: every span
metric of the live cell reads, and the device's idle split does not."""
import pytest

import bench_tiny
from harness import readers, runner, trace
from repro_torch.trace import Snapshot, Span

MS = 1_000_000                      # ns
C0 = 1_700_000_000_000_000_000      # the profiler's clock at perf 0
D, P = 1, 2                         # driver and producer threads

SPAN_METRICS = {
    "step.ready_to_sink_ms_p95.live", "source.fetch_lag_ms_p95.live",
    "source.ring_copy_ms_per_step.live",
    "source.ring_copy_late_ms_per_step.live", "source.early_copy_pct.live",
    "source.push_wait_ms_per_step.live", "h2d.stage_ms_per_step.live"}


def _spans() -> list:
    """Two steps of a live job, in ms on ``perf_counter``: step 10 takes
    3 records early and waits for its 4th; step 11's 4 land at once.  A
    step before the window (begun at 0.2 ms) is not the window's."""
    rows = [  # id, parent, name, thread, start, end, attrs
        (1, None, "job.step", D, 0.2, 0.9, {"step": 9}),
        (2, 1, "source.copy", D, 0.3, 0.4, {"records": 4, "early": False}),
        (10, None, "job.step", D, 2, 12, {"step": 10}),
        (11, 10, "source.wait", D, 2, 5, {}),
        (12, 10, "source.copy", D, 5, 6, {"records": 3, "early": True}),
        (13, 10, "source.wait", D, 6, 8, {"ready_ns": int(7.5 * MS)}),
        (14, 10, "source.copy", D, 8, 8.5, {"records": 1, "early": False}),
        (15, 10, "job.h2d", D, 8.5, 9, {"step": 10}),
        (16, 15, "h2d.stage", D, 8.6, 8.7, {}),
        (17, 10, "job.dispatch", D, 9, 11, {"step": 10}),
        (18, 10, "job.drain", D, 11, 12, {"step": 10}),
        (20, None, "job.step", D, 20, 30, {"step": 11}),
        (21, 20, "source.wait", D, 20, 27, {"ready_ns": 26 * MS}),
        (22, 20, "source.copy", D, 27, 28, {"records": 4, "early": False}),
        (23, 20, "job.h2d", D, 28, 28.4, {"step": 11}),
        (24, 23, "h2d.stage", D, 28.1, 28.3, {}),
        (25, 20, "job.dispatch", D, 28.4, 29.5, {"step": 11}),
        (26, 20, "job.drain", D, 29.5, 30, {"step": 11}),
        (30, None, "source.push", P, 3, 3.2, {"record": 7}),
        (31, 30, "source.push_wait", P, 3, 3.1, {}),
        (32, None, "source.push", P, 21, 21.2, {"record": 8}),
        (33, 32, "source.push_wait", P, 21, 21.05, {}),
    ]
    return [Span(i, par, name, th, int(a * MS), int(b * MS), attrs)
            for i, par, name, th, a, b, attrs in rows]


def _program(dropped: int = 0) -> trace.Program:
    """The snapshots at the window's start (perf 1 ms) and end (101 ms);
    the profiler's clock runs ``C0`` ahead of ``perf_counter``."""
    first = Snapshot([], ((0, C0), (1 * MS, C0 + 1 * MS)), 0)
    last = Snapshot(_spans(), ((0, C0), (101 * MS, C0 + 101 * MS)),
                    dropped)
    return trace.Program.between(first, last)


class _Win:
    def __init__(self, program, summary=None):
        self.program, self.trace, self.steps = program, summary, 2


def _summary() -> trace.Summary:
    """The traced window 2-30 ms; the device busy 9.5-11 and 29-29.6."""
    return trace.Summary(
        window_s=0.028, busy_s=0.0021, device_ops=2, op_seconds={},
        span_device_s={}, idle_by_label={},
        window_ns=(C0 + 2 * MS, C0 + 30 * MS),
        busy_ns=[[C0 + 19 * MS // 2, C0 + 11 * MS],
                 [C0 + 29 * MS, C0 + 296 * MS // 10]])


def test_the_window_keeps_the_spans_begun_in_it():
    p = _program()
    assert len(p.named("job.step")) == 2 and p.driver() == D
    assert p.step_of[14] == 10 and p.step_of[24] == 11 and 31 not in p.step_of
    assert p.to_profiler(5 * MS) == C0 + 5 * MS


def test_span_readers_give_exact_values():
    win = _Win(_program())
    approx = lambda v: pytest.approx(v, rel=1e-12)  # noqa: E731
    # step 10: drain's end 12 - ready 7.5; step 11: 30 - 26; p95 of two
    assert readers.ready_to_sink_ms_p95(win) == approx(4.0 + 0.95 * 0.5)
    # step 10: wait's end 8 - 7.5; step 11: 27 - 26
    assert readers.fetch_lag_ms_p95(win) == approx(0.5 + 0.95 * 0.5)
    assert readers.span_ms_per_step(win, "source.copy") \
        == approx((1 + 0.5 + 1) / 2)
    assert readers.span_ms_per_step(win, "source.copy", early=False) \
        == approx((0.5 + 1) / 2)
    assert readers.early_copy_pct(win) == approx(100 * 3 / 8)
    assert readers.span_ms_per_step(win, "source.push_wait", driver=False) \
        == approx((0.1 + 0.05) / 2)
    assert readers.span_ms_per_step(win, "h2d.stage") \
        == approx((0.1 + 0.2) / 2)


def test_host_bound_idle_splits_each_idle_interval_by_overlap():
    """Idle 2-9.5, 11-29, 29.6-30 ms (25.9 of 28), of which 12 under
    ``source.wait`` (2-5, 6-8, 20-27)."""
    win = _Win(_program(), _summary())
    assert readers.host_bound_idle_pct(win) \
        == pytest.approx(100 * (25.9 - 12) / 28, rel=1e-12)
    assert readers.host_bound_idle_pct(_Win(_program())) is None


@pytest.mark.parametrize("win", [_Win(None, _summary()),
                                 _Win(_program(dropped=1), _summary())],
                         ids=["no_program", "a_span_dropped"])
def test_span_readers_read_nothing_without_every_span(win):
    for read in (readers.ready_to_sink_ms_p95, readers.fetch_lag_ms_p95,
                 readers.early_copy_pct, readers.host_bound_idle_pct,
                 lambda w: readers.span_ms_per_step(w, "source.copy")):
        assert read(win) is None


def test_program_block_reports_kept_dropped_coverage_and_skew():
    """Each driver span has its own range in the profiler's trace, 5 us
    late; one 40 us late."""
    p = _program()
    events = [trace.Event(trace.WINDOW_SPAN, "user_annotation",
                          C0 + 2 * MS, C0 + 30 * MS, 0, 0, 9)]
    for s in p.spans:
        if s.thread == D:
            late = 40_000 if s.id == 17 else 5_000
            events.append(trace.Event(s.name, "user_annotation",
                                      C0 + s.start_ns + late, C0 + s.end_ns,
                                      0, 0, 9))
    block = p.block(events)
    assert block == {"kept": len(_spans()) - 2, "dropped": 0,
                     "job_step_pct": pytest.approx(100 * 20 / 100),
                     "skew_us_median": pytest.approx(5.0),
                     "skew_us_max": pytest.approx(40.0)}


def test_segments_label_time_by_the_innermost_span():
    segs = trace.segments([(0, 10, "step"), (2, 4, "wait"), (4, 5, "copy"),
                           (7, 9, "dispatch"), (8, 9, "kernel"),
                           (12, 14, "step")])
    assert segs == [(0, 2, "step"), (2, 4, "wait"), (4, 5, "copy"),
                    (5, 7, "step"), (7, 8, "dispatch"), (8, 9, "kernel"),
                    (9, 10, "step"), (12, 14, "step")]
    split = trace.split([(1, 3), (9, 13)], segs)
    assert split == {"step": 1 + 1 + 1, "wait": 1, trace.NO_SPAN: 2}


def test_breakdown_splits_idle_by_overlap_not_the_midpoint():
    """Idle 0-40 ns is 30 under ``source.wait`` and 10 under
    ``source.copy`` (the midpoint rule gave all 40 to the wait); idle
    50-100 is 10 under ``job.dispatch`` and 40 under no span."""
    ev = [trace.Event(trace.WINDOW_SPAN, "user_annotation", 0, 100, 1, 0, 7),
          trace.Event("source.wait", "user_annotation", 0, 30, 2, 0, 7),
          trace.Event("source.copy", "user_annotation", 30, 45, 3, 0, 7),
          trace.Event("job.dispatch", "user_annotation", 45, 60, 4, 0, 7),
          trace.Event("k", "kernel", 40, 50, 5, 0, 99)]
    s = trace.summarize(ev, set())
    assert s.window_ns == (0, 100) and s.busy_ns == [[40, 50]]
    assert s.idle_ns() == [(0, 40), (50, 100)]
    assert s.idle_by_label == {"source.wait": 30e-9, "source.copy": 10e-9,
                               "job.dispatch": 10e-9, trace.NO_SPAN: 40e-9}
    assert trace.breakdown(s)["idle_gaps"][0] == [trace.NO_SPAN, 40e-9]


def test_traced_rehearsal_reads_every_span_metric():
    out = bench_tiny.run("set1.live", traced=True)
    assert out["correct"], out["checks"]
    assert SPAN_METRICS <= set(out["metrics"])
    assert "device.host_bound_idle_pct.live" not in out["metrics"]
    assert 0 <= out["metrics"]["source.early_copy_pct.live"]["value"] <= 100
    block = out["program_trace"]
    assert block["dropped"] == 0 and block["kept"] > 0
    assert 0 < block["job_step_pct"] <= 100


def test_a_program_without_a_tracer_reads_no_span(monkeypatch):
    monkeypatch.setattr(runner, "program_tracer", lambda: None)
    out = bench_tiny.run("set1.live", traced=True)
    assert out["correct"], out["checks"]
    assert not SPAN_METRICS & set(out["metrics"])
    assert "h2d.ms_per_step.live" in out["metrics"]
    assert "program_trace" not in out


def test_params_pass_every_field_the_configuration_names():
    from harness import discover
    from repro_torch.core.params import DepamParams
    spec = discover.benchmark()
    cfg = discover.config(spec, "depam_set1")
    assert runner.params(cfg) == DepamParams(
        fs=32768.0, nfft=256, window_size=256, window_overlap=128,
        record_size_sec=60.0, window="hamming", tol_fmin=10.0)
    cfg = dict(cfg, event_threshold_db=72, event_capacity=4, gain_db=1.5)
    p = runner.params(cfg)
    assert (p.event_threshold_db, p.event_capacity, p.gain_db) == (72.0, 4,
                                                                    1.5)
    assert isinstance(p.event_capacity, int)
