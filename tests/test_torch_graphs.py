"""The step's chains (``api.graphs.StepGraphs``): the frame statistics
after the per-frame PSD, and the carry update.

  * on the CPU every chain runs eagerly; ``job.dispatch`` counts the
    step's chain runs (``replays``, ``captures``, ``eager``), and the
    frame statistics the job's first step reads, each alone, are the
    ones every later step computes as one chain;
  * on the card (``-m cuda``) the chains are captured as CUDA graphs
    and replayed, and the job's outputs have the bits of the same job
    with every chain eager: paper set 2's detection step over 24 steps
    whose 8 records cross window edges at every offset the 90-record
    windows of the benchmark give (2, 4, 6 records before an edge, and
    none), with a step in flight, over four shard rows, and as two
    service tenants sharing one compiled step; paper set 1's live step
    over 8 steps.  Each structure is captured once, every other chain
    run of a step after the first is a replay.
"""
import numpy as np
import pytest
import torch

from repro_torch import api, trace
from repro_torch.api import engine, graphs
from repro_torch.core import spectra
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2, DepamParams

DETECT = ("welch", "percentiles", "spd")


def _reader(p, seed=7):
    """Raw int16 PCM per record, pure in the index: noise with a few
    strikes (200-Hz pulses 23.5 dB up, falling by e over 20 ms)."""
    n = int(0.02 * p.fs)
    pulse = 15 * np.sin(2 * np.pi * 200 * np.arange(n) / p.fs) \
        * np.exp(-np.arange(n) / n)

    def read(idx):
        idx = np.asarray(idx)
        out = np.empty((idx.size, p.record_size), np.int16)
        for j, i in enumerate(idx.reshape(-1)):
            rng = np.random.default_rng(seed * 100_003 + int(i))
            x = rng.normal(0.0, 1.0, p.record_size)
            for t in rng.integers(0, p.record_size - n, 6):
                x[t:t + n] += pulse
            out[j] = np.round(np.clip(x * 2000.0, -32767, 32767))
        return out.reshape(idx.shape + (p.record_size,))
    return read


def _scales(idx):
    return np.full(np.shape(idx), 1.0 / 2000.0, np.float32)


def _threshold(p) -> float:
    """6 dB over the median frame level of two records, so that the
    strikes open events."""
    x = torch.from_numpy(_reader(p)(np.arange(2)).astype(np.float32)
                         / 2000.0)
    spl = spectra.db(torch.sum(spectra.frame_psd(x, p), dim=-1) * p.df, p)
    return float(torch.median(spl)) + 6.0


def _job(p, m, device, features, window=None):
    j = (api.job(m, p).features(*features)
         .source(api.ReaderSource(_reader(p), payload_dtype="int16",
                                  scales=_scales))
         .payload("int16").device(device))
    if window is not None:
        j = j.window(records=window)
    return j


def _detect_job(device, n_steps=24, window=30, threshold=None):
    """Set 2's detection step, 8 records a step; 30-record windows put
    an edge 6, 4, 2 and 0 records into successive steps (90 mod 8 = 2,
    as the benchmark's 15-min windows do)."""
    p = PARAM_SET_2
    m = DatasetManifest(n_files=1, records_per_file=8 * n_steps,
                        record_size=p.record_size, fs=p.fs)
    thr = _threshold(p) if threshold is None else threshold
    return (_job(p, m, device, DETECT, window)
            .events(threshold_db=thr, impulsive=True).chunk(8))


def _live_job(device, n_steps=8):
    p = PARAM_SET_1
    m = DatasetManifest(n_files=1, records_per_file=4 * n_steps,
                        record_size=p.record_size, fs=p.fs)
    return _job(p, m, device, ("welch", "spl", "tol")).chunk(4)


def _assert_bitwise(a, b):
    for da, db in ((a.features or {}, b.features or {}),
                   (a.epoch, b.epoch), (a.windows, b.windows)):
        assert sorted(da) == sorted(db)
        for k in da:
            assert np.array_equal(np.asarray(da[k]).view(np.uint8),
                                  np.asarray(db[k]).view(np.uint8)), k
    ea, eb = a.events or {}, b.events or {}
    assert sorted(ea) == sorted(eb)
    for k in ea:
        assert np.array_equal(ea[k].counts, eb[k].counts), k
        assert np.array_equal(ea[k].rows.view(np.uint8),
                              eb[k].rows.view(np.uint8)), k


def _dispatch_counts(job) -> tuple:
    """Run ``job`` traced; its result and each ``job.dispatch``'s
    ``(replays, captures, eager)``."""
    trace.enable()
    try:
        res = job.run()
        spans = trace.snapshot().spans
    finally:
        trace.disable()
    return res, [(s.attrs["replays"], s.attrs["captures"], s.attrs["eager"])
                 for s in spans if s.name == "job.dispatch"]


def _eager(mp):
    """Every job built after this runs its chains eagerly."""
    mp.setattr(engine, "StepGraphs", lambda device: graphs.StepGraphs(None))


# -- the CPU ---------------------------------------------------------------

P_SMALL = DepamParams(nfft=256, window_size=256, window_overlap=128,
                      record_size_sec=0.0625)


def test_cpu_chains_run_eagerly_and_are_counted():
    m = DatasetManifest(n_files=2, records_per_file=5,
                        record_size=P_SMALL.record_size, fs=P_SMALL.fs)
    job = (_job(P_SMALL, m, "cpu", DETECT, window=3)
           .events(threshold_db=_threshold(P_SMALL)).chunk(2))
    res, counts = _dispatch_counts(job)
    # the first step: the carry alone is a chain run (each frame
    # statistic is computed alone, as asked); later steps: both chains
    assert counts == [(0, 0, 1)] + [(0, 0, 2)] * (len(counts) - 1)
    assert len(counts) == 5
    st = (_job(P_SMALL, m, "cpu", DETECT, window=3)
          .events(threshold_db=_threshold(P_SMALL)).chunk(2))._stepper()
    st.start()
    try:
        st.step_once()
        assert st._graphs[0].uses == {"frame_stats": [
            "frame_db", "percentiles", "frame_spl", "frame_peak_bin"]}
    finally:
        st.close()
    with pytest.MonkeyPatch.context() as mp:
        _eager(mp)
        _assert_bitwise(res, (_job(P_SMALL, m, "cpu", DETECT, window=3)
                              .events(threshold_db=_threshold(P_SMALL))
                              .chunk(2)).run())


def test_a_context_outside_a_job_computes_each_statistic_alone():
    """A ``FeatureContext`` built without the job's graphs (as a script
    does) never captures, and asks for what it reads only."""
    x = torch.from_numpy(_reader(P_SMALL)(np.arange(3)).astype(np.float32))
    ctx = api.FeatureContext(x, P_SMALL, True, {})
    spl = ctx.frame_spl
    assert set(ctx._cache) == {"frame_psd", "frame_spl"}
    assert torch.equal(spl, spectra.db(
        torch.sum(ctx.frame_psd, dim=-1) * P_SMALL.df, P_SMALL))
    assert not ctx.graphs.capture and not ctx.graphs.owns(spl)


# -- the card --------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs are captured only there")


def _structures(job_factory) -> int:
    """The distinct carry layouts of steps after the first (what a
    carry graph is keyed on besides its shapes)."""
    st = job_factory()._stepper()
    st.start()
    try:
        seen = set()
        for step in range(1, st.n_steps):
            idx = st.pl.step_indices(step)
            segments, _ = engine._window_rows(
                {k: w.ids(idx, st.m) for k, w in st._wins.items()})
            seen.add(tuple((k, tuple(tuple(r) for _, r in
                                     engine._window_hits(runs)))
                           for k, runs in segments.items()))
        return len(seen)
    finally:
        st.close()


@pytest.mark.cuda
def test_detect_step_graphs_have_the_eager_bits(monkeypatch):
    _needs_card()
    thr = _threshold(PARAM_SET_2)
    got, counts = _dispatch_counts(_detect_job("cuda", threshold=thr))
    assert (got.events["events"].counts > 0).mean() > 0.5
    n = len(counts)
    assert n == 24
    layouts = _structures(lambda: _detect_job("cuda", threshold=thr))
    assert layouts == 4           # no edge, and edges 6, 4, 2 records in
    captures = 1 + layouts        # the frame chain, each carry layout
    assert counts[0] == (0, 0, 1)
    assert sum(c[1] for c in counts) == captures
    assert sum(c[0] for c in counts) == 2 * (n - 1) - captures
    assert sum(c[2] for c in counts) == 1
    with monkeypatch.context() as mp:
        _eager(mp)
        want = _detect_job("cuda", threshold=thr).run()
    _assert_bitwise(got, want)


@pytest.mark.cuda
def test_live_step_graph_has_the_eager_bits(monkeypatch):
    _needs_card()
    got, counts = _dispatch_counts(_live_job("cuda"))
    assert counts == [(0, 0, 1), (0, 1, 0)] + [(1, 0, 0)] * 6
    with monkeypatch.context() as mp:
        _eager(mp)
        want = _live_job("cuda").run()
    _assert_bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["inflight1", "shards4"])
def test_graphs_keep_the_eager_bits_in_flight_and_over_shard_rows(
        layout, monkeypatch):
    _needs_card()
    thr = _threshold(PARAM_SET_2)

    def job():
        j = _detect_job("cuda", n_steps=16, threshold=thr)
        return j.async_io(depth=0, inflight=1) if layout == "inflight1" \
            else j.shards(4).chunk(2)
    got, counts = _dispatch_counts(job())
    assert sum(c[0] for c in counts) > sum(c[1] for c in counts) > 0
    with monkeypatch.context() as mp:
        _eager(mp)
        want = job().run()
    _assert_bitwise(got, want)


@pytest.mark.cuda
def test_service_tenants_sharing_a_step_each_have_their_solo_bits():
    _needs_card()
    from repro_torch.serve import SoundscapeService
    thr = _threshold(PARAM_SET_2)
    solo = _detect_job("cuda", n_steps=12, threshold=thr).run()
    svc = SoundscapeService(quantum=1)
    handles = [_detect_job("cuda", n_steps=12, threshold=thr)
               .submit(svc, name=f"t{i}") for i in range(2)]
    svc.run(timeout=600)
    for h in handles:
        _assert_bitwise(h.result(), solo)
    assert svc.stats()["compile"]["step"]["entries"] == 1
