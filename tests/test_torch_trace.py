"""The port's tracer (``repro_torch.trace``): off is a shared no-op that
records nothing, and a live job's spans and clock pairs when on (on the
CPU; the pinned staging spans on the card).  ``host_seconds`` and the spans come from the same clock
reads, and a driver-thread span lands in the profiler's events at the
stamp the clock pairs map it to."""
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api, trace
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.serve import LiveSource

P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.0625)
M = DatasetManifest(n_files=2, records_per_file=6, record_size=P.record_size,
                    fs=P.fs, seed=3)
CHUNK = 2
STEP_CHILDREN = {"source.wait", "source.copy", "job.h2d", "job.dispatch"}


@pytest.fixture
def tracer():
    """Tracing on for the test, and off again whatever happens."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3000, 3000, (n, P.record_size)).astype(np.int16)


def _run_live(inflight: int, device: str = "cpu"):
    """A job over a LiveSource fed from a producer thread; returns the
    stepper (closed), the source, the producer's thread id and the steps
    run."""
    live = LiveSource(P.record_size, capacity=8, payload_dtype="int16")
    recs = _records(M.n_records)
    st = (api.job(M, P).features("welch", "spl", "tol").source(live)
          .to(api.CallbackSink(lambda *a: None)).chunk(CHUNK)
          .async_io(depth=0, inflight=inflight).payload("int16")
          .device(device))._stepper()
    producer = threading.Thread(target=live.feed,
                                args=(recs, np.full(len(recs), 1e-4)))
    st.start()
    producer.start()
    steps = 0
    try:
        while st.step_once():
            steps += 1
        st.finish()
    finally:
        producer.join(timeout=60)
        st.close()
    assert not producer.is_alive()
    return st, live, producer.ident, steps


def test_off_span_is_the_shared_noop_and_records_nothing():
    trace.enable()
    trace.disable()
    assert not trace.active
    assert trace.span("job.step", step=1) is trace.OFF
    assert trace.span("source.wait") is trace.OFF
    with trace.span("x") as s:
        assert not s
        s.set(ready_ns=1)
    trace.begin("x", 1, step=0)
    trace.end(2)
    st, live, _, steps = _run_live(0)
    assert steps == M.n_records // CHUNK
    snap = trace.snapshot()
    assert snap.spans == [] and snap.dropped == 0
    assert not live._stamp.any()        # no push stamp written
    assert set(st.host_seconds) == {"h2d", "dispatch", "d2h_wait", "sink"}


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


@pytest.mark.parametrize("inflight", [0, 1])
def test_on_records_each_step_with_its_id_and_parent(tracer, inflight):
    driver = threading.get_ident()
    st, live, producer, steps = _run_live(inflight)
    snap = trace.snapshot()
    spans = snap.spans
    assert snap.dropped == 0
    kids = _children(spans)
    jobs = sorted((s for s in spans if s.name == "job.step"),
                  key=lambda s: s.attrs["step"])
    assert [s.attrs["step"] for s in jobs] == list(range(steps))
    for js in jobs:
        assert js.thread == driver and js.parent is None
        names = [c.name for c in kids.get(js.id, [])]
        assert STEP_CHILDREN <= set(names), names
        # the ring copies each record as it lands: one wait and one copy
        # or more a step, the copies together the step's live records,
        # and the last wait stamped with the last record's push
        copies = [c for c in kids[js.id] if c.name == "source.copy"]
        waits = sorted((c for c in kids[js.id] if c.name == "source.wait"),
                       key=lambda c: c.start_ns)
        assert sum(c.attrs["records"] for c in copies) \
            == st.pl.step_mask(js.attrs["step"]).sum()
        assert waits[-1].attrs["ready_ns"] <= waits[-1].end_ns
        assert all("ready_ns" not in w.attrs for w in waits[:-1])
        for c in kids[js.id]:
            assert c.thread == driver
            assert js.start_ns <= c.start_ns <= c.end_ns <= js.end_ns
            if c.name in ("job.h2d", "job.dispatch"):
                assert c.attrs["step"] == js.attrs["step"]
            if c.name == "job.h2d":
                assert c.id not in kids     # no staging on the CPU
            if c.name == "job.drain":
                # the step drained, not the one dispatched
                assert c.attrs["step"] == js.attrs["step"] - inflight
    drains = [s for s in spans if s.name == "job.drain"]
    assert sorted(s.attrs["step"] for s in drains) == list(range(steps))
    # self time: a span's length less what its children cover
    by_id = {s.id: s for s in spans}
    for s in spans:
        covered = sum(c.end_ns - c.start_ns for c in kids.get(s.id, []))
        assert s.end_ns - s.start_ns - covered >= 0, s
        assert s.parent is None or s.parent in by_id
    pushes = [s for s in spans if s.name == "source.push"]
    waits = [s for s in spans if s.name == "source.push_wait"]
    assert len(pushes) == M.n_records
    assert {s.thread for s in pushes + waits} == {producer}
    assert sorted(s.attrs["record"] for s in pushes) \
        == list(range(M.n_records))
    for p in pushes:
        # one record a push: the wait for the lock, then for room
        assert [w.name for w in kids[p.id]] == ["source.push_wait"] * 2
    assert len(waits) == 2 * M.n_records
    assert live._stamp.all()


def test_host_seconds_are_the_sums_of_their_spans(tracer):
    st, _, _, _ = _run_live(1)
    spans = trace.snapshot().spans

    def total(name):
        return sum(s.end_ns - s.start_ns for s in spans
                   if s.name == name) / 1e9

    hs = st.host_seconds
    assert hs["h2d"] == pytest.approx(total("job.h2d"), rel=1e-9, abs=1e-12)
    assert hs["dispatch"] == pytest.approx(total("job.dispatch"), rel=1e-9,
                                           abs=1e-12)
    assert hs["d2h_wait"] + hs["sink"] == pytest.approx(
        total("job.drain"), rel=1e-9, abs=1e-12)


def test_profiler_sees_driver_spans_at_the_mapped_stamps(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("trace.warm"):
            pass
        for i in range(10):
            with trace.span("trace.probe", i=i):
                time.sleep(0.002)
    snap = trace.snapshot()
    (p1, w1), (p2, w2) = snap.clocks
    assert p2 > p1

    def mapped(t):
        return w1 + (t - p1) * (w2 - w1) / (p2 - p1)

    ours = sorted((s for s in snap.spans if s.name == "trace.probe"),
                  key=lambda s: s.start_ns)
    theirs = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "trace.probe"),
                    key=lambda e: e.start_ns())
    assert len(ours) == len(theirs) == 10
    starts = [abs(mapped(s.start_ns) - e.start_ns())
              for s, e in zip(ours, theirs)]
    ends = [abs(mapped(s.end_ns) - e.end_ns()) for s, e in zip(ours, theirs)]
    assert statistics.median(starts) < 1e6, starts
    assert statistics.median(ends) < 1e6, ends


def test_buffer_stops_at_capacity_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.enable()
    try:
        with trace.span("outer"):
            for i in range(4):
                with trace.span("inner", i=i):
                    pass
        snap = trace.snapshot()
    finally:
        trace.disable()
    assert [s.attrs["i"] for s in snap.spans] == [0, 1, 2]
    assert snap.dropped == 2


def test_an_exception_closes_the_spans_it_left_open(tracer):
    with pytest.raises(RuntimeError):
        with trace.span("outer"):
            trace.begin("phase", step=1)
            raise RuntimeError("boom")
    with trace.span("after"):
        pass
    spans = {s.name: s for s in trace.snapshot().spans}
    assert spans["phase"].parent == spans["outer"].id
    assert spans["phase"].end_ns == spans["outer"].end_ns
    assert spans["after"].parent is None


@pytest.mark.cuda
def test_staging_on_the_card_is_a_child_of_each_h2d(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    _run_live(0, device="cuda")
    spans = trace.snapshot().spans
    kids = _children(spans)
    h2d = [s for s in spans if s.name == "job.h2d"]
    assert len(h2d) == M.n_records // CHUNK
    for s in h2d:
        stage = kids.get(s.id, [])
        assert stage and {c.name for c in stage} == {"h2d.stage"}
        assert all(s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
                   for c in stage)


P_DET = DepamParams(nfft=256, window_size=256, window_overlap=0,
                    record_size_sec=256 * 8 / 32768)
M_DET = DatasetManifest(n_files=1, records_per_file=7,
                        record_size=P_DET.record_size, fs=P_DET.fs)
DET_WINDOW = 3


def _burst_records(n):
    """int16 records of 8 frames, loud in every other frame: four events
    a record."""
    rng = np.random.default_rng(4)
    x = rng.integers(-100, 100, (n, P_DET.record_size)).astype(np.int16)
    for f in range(0, 8, 2):
        t = np.arange(256)
        x[:, f * 256:(f + 1) * 256] += (20000 * np.sin(0.3 * t)).astype(
            np.int16)
    return x


def _run_detect(capacity: int):
    """A detection job streaming closed windows and events to callbacks;
    returns the live records of each step and the closed windows."""
    recs = _burst_records(M_DET.n_records)
    src = api.ReaderSource(lambda idx: recs[np.asarray(idx) % len(recs)],
                           payload_dtype="int16")
    got = {"windows": 0}

    def on_windows(name, start, values):
        got["windows"] += len(values)

    (api.job(M_DET, P_DET).features("welch", "spd")
     .events(threshold_db=-30.0, hysteresis_db=3.0, capacity=capacity)
     .window(records=DET_WINDOW).source(src).payload("int16").chunk(2)
     .to(api.CallbackSink(lambda *a: None, on_windows=on_windows,
                          on_events=lambda *a: None))
     .device("cpu").run())
    return got


def test_carry_flush_and_compaction_spans_carry_their_counters(tracer):
    with pytest.warns(RuntimeWarning, match="event capacity overflow"):
        got = _run_detect(capacity=1)
    spans = trace.snapshot().spans
    by_id = {s.id: s for s in spans}
    n_windows = -(-M_DET.n_records // DET_WINDOW)
    row_bytes = P_DET.n_bins * api.SPD_N_DB * 4     # int32 counts, f32 rows
    assert got["windows"] == n_windows

    carry = [s for s in spans if s.name == "job.carry"]
    steps = -(-M_DET.n_records // 2)
    assert len(carry) == steps
    for s in carry:
        parent = by_id[s.parent]
        assert parent.name == "job.dispatch"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.attrs["windows"] >= 2          # the epoch and a window
    assert sum(s.attrs["d2h_bytes"] for s in carry) == n_windows * row_bytes

    flush = [s for s in spans if s.name == "job.flush"]
    compact = [s for s in spans if s.name == "drain.compact"]
    assert len(flush) == len(compact) == steps
    for s in flush + compact:
        parent = by_id[s.parent]
        assert parent.name == "job.drain"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert sum(s.attrs["windows"] for s in flush) == n_windows
    assert sum(s.attrs["bytes"] for s in flush) == n_windows * row_bytes
    assert sum(s.attrs["records"] for s in compact) == M_DET.n_records
    for s in compact:
        # four events a record, one kept: every record overflows
        assert s.attrs["events"] == s.attrs["records"]
        assert s.attrs["overflow"] == s.attrs["records"] > 0


def test_carry_flush_and_compaction_record_nothing_when_off():
    trace.enable()
    trace.disable()
    _run_detect(capacity=16)
    assert trace.snapshot().spans == []
