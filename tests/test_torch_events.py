"""K6 detection, the spectrogram features and the event log: the port
against the reference, and the port's own invariants.

  * detection — the port's plain version (what the wrapper runs on a
    CPU tensor), the reference's XLA scan and its Pallas kernel
    (interpret mode), and the port's frame-by-frame oracle agree BITWISE
    on the same (spl, peak_bin) inputs: the reference's edge cases, a
    hypothesis sweep, and chip_smoke.py's adversarial K6 traces (NaN,
    +-inf, exact threshold and close level, peak ties, events open to
    the record end, overflow) at small frame counts;
  * the detection job — ``percentiles``/``spd``/``events``/``impulsive``
    read from wav files against the reference job, for the direct (set
    1) and the Cooley-Tukey shape, float32 and int16;
  * impulsive metrics against a float64 numpy oracle;
  * durability — the event log through ``StoreSink`` resumes bitwise,
    rows appended after the last commit vanish on resume, and a resume
    into a store without the log is refused.
"""
import dataclasses
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # stubs so decorators at class-body time work
    HAVE_HYPOTHESIS = False

    def given(*a, **k):
        return lambda f: f

    def settings(*a, **k):
        return lambda f: f

    class _St:
        def __call__(self, *a, **k):
            return self

        def __getattr__(self, name):
            return self

    st = _St()

import jax.numpy as jnp

from repro import api as japi
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro.kernels import events as jev
from repro_torch import api
from repro_torch.core import spectra
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore
from repro_torch.data.wavio import write_dataset
from repro_torch.kernels import events, ops, ref

needs_hypothesis = pytest.mark.skipif(
    not HAVE_HYPOTHESIS,
    reason="optional dev dependency: pip install hypothesis")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

P0 = DepamParams(nfft=256, window_size=256, window_overlap=128,
                 record_size_sec=0.25)


# -- detection: plain == XLA == Pallas == oracle, bitwise ------------------

def run_all(spl, pk_bin, block_records=8, **kw):
    kw = dict({"min_len": 1, "capacity": 16}, **kw)
    spl = np.asarray(spl, np.float32)
    pb = np.asarray(pk_bin, np.int32)
    c, r = events.detect_events(torch.as_tensor(spl), torch.as_tensor(pb),
                                **kw)
    c, r = c.numpy(), r.numpy()
    assert c.dtype == np.int32 and r.dtype == np.float32
    p = dataclasses.replace(
        P0, event_threshold_db=kw["threshold_db"],
        event_hysteresis_db=kw["hysteresis_db"],
        event_min_len=kw["min_len"], event_capacity=kw["capacity"])
    oc, orows = ref.detect_events(torch.as_tensor(spl), torch.as_tensor(pb),
                                  p)
    xc, xr = jev.detect_events_xla(jnp.asarray(spl), jnp.asarray(pb), **kw)
    kc, kr = jev.detect_events(jnp.asarray(spl), jnp.asarray(pb),
                               block_records=block_records, interpret=True,
                               **kw)
    for name, (wc, wr) in (("oracle", (oc, orows)), ("xla", (xc, xr)),
                           ("pallas", (kc, kr))):
        assert np.array_equal(c, np.asarray(wc)), (name, "counts")
        assert np.array_equal(r, np.asarray(wr)), (name, "rows")
    return c, r


class TestDetectionEdgeCases:
    def rand(self, b=3, f=40, seed=0):
        rng = np.random.default_rng(seed)
        return (rng.standard_normal((b, f)).astype(np.float32) * 10.0,
                rng.integers(0, 129, (b, f)).astype(np.int32))

    def test_zero_events(self):
        spl, pb = self.rand()
        c, r = run_all(spl, pb, threshold_db=1e4, hysteresis_db=3.0,
                       capacity=4)
        assert not c.any() and not r.any()

    def test_all_frames_above(self):
        spl, pb = self.rand()
        spl = np.abs(spl) + 100.0
        c, r = run_all(spl, pb, threshold_db=50.0, hysteresis_db=3.0,
                       capacity=4)
        assert (c == 1).all()
        assert (r[:, 0, 0] == 0).all() and (r[:, 0, 1] == 40).all()

    def test_edge_touching_events(self):
        spl = np.full((1, 8), -50.0, np.float32)
        spl[0, [0, 1, 7]] = (10.0, 11.0, 9.0)
        pb = np.arange(8, dtype=np.int32)[None, :]
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=2.0,
                       capacity=4)
        assert c[0] == 2
        assert r[0, 0].tolist() == [0.0, 2.0, 1.0, 11.0]
        assert r[0, 1].tolist() == [7.0, 1.0, 7.0, 9.0]

    def test_overflow_keeps_true_count_and_first_k(self):
        spl = np.where(np.arange(20) % 2 == 0, 10.0, -50.0) \
            .astype(np.float32)[None, :]
        pb = np.zeros((1, 20), np.int32)
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=1.0,
                       capacity=2)
        assert c[0] == 10 and r.shape[1] == 2
        assert r[0, :, 0].tolist() == [0.0, 2.0]

    def test_min_len_drops_short_events(self):
        spl = np.full((1, 12), -50.0, np.float32)
        spl[0, 2] = 10.0
        spl[0, 6:9] = 10.0
        pb = np.zeros((1, 12), np.int32)
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=1.0,
                       capacity=4, min_len=2)
        assert c[0] == 1 and r[0, 0, :2].tolist() == [6.0, 3.0]

    def test_hysteresis_holds_event_open_through_dips(self):
        spl = np.array([[5.0, -2.0, 6.0, -4.0, -50.0, -50.0]], np.float32)
        pb = np.zeros((1, 6), np.int32)
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=3.0,
                       capacity=4)
        assert c[0] == 1 and r[0, 0, :2].tolist() == [0.0, 3.0]
        assert r[0, 0, 3] == np.float32(6.0)

    def test_single_frame_record(self):
        spl = np.array([[3.0], [-3.0]], np.float32)
        pb = np.zeros((2, 1), np.int32)
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=1.0,
                       capacity=2)
        assert c.tolist() == [1, 0] and r[0, 0, :2].tolist() == [0.0, 1.0]

    def test_close_level_rounds_in_float32(self):
        """lo = f32(thr) - f32(hyst), one f32 rounding: a frame exactly
        at that level stays open, one ulp below closes."""
        thr, hyst = 0.1, 0.3
        lo = np.float32(thr) - np.float32(hyst)
        below = np.nextafter(lo, np.float32(-np.inf))
        spl = np.array([[1.0, lo, 1.0, below, -9.0]], np.float32)
        c, r = run_all(spl, np.zeros((1, 5), np.int32), threshold_db=thr,
                       hysteresis_db=hyst, capacity=2)
        assert c[0] == 1 and r[0, 0, :2].tolist() == [0.0, 3.0]

    def test_ties_keep_the_first_frame(self):
        spl = np.array([[5.0, 7.0, 7.0, 6.0, -9.0]], np.float32)
        pb = np.array([[1, 2, 3, 4, 5]], np.int32)
        c, r = run_all(spl, pb, threshold_db=0.0, hysteresis_db=1.0,
                       capacity=2)
        assert r[0, 0, 2:].tolist() == [2.0, 7.0]

    def test_ops_entry_point_reads_the_params(self):
        spl, pb = self.rand(seed=4)
        p = dataclasses.replace(P0, event_threshold_db=5.0,
                                event_hysteresis_db=2.0, event_capacity=3,
                                event_min_len=2)
        got = ops.detect_events(torch.as_tensor(spl), torch.as_tensor(pb), p)
        plain = ops.detect_events(torch.as_tensor(spl), torch.as_tensor(pb),
                                  p, kernel=False)
        want = run_all(spl, pb, threshold_db=5.0, hysteresis_db=2.0,
                       capacity=3, min_len=2)
        for a, b, w in zip(got, plain, want):
            assert np.array_equal(a.numpy(), w)
            assert np.array_equal(b.numpy(), w)

    def test_rejects_mismatched_shapes(self):
        with pytest.raises(ValueError, match="one shape"):
            events.detect_events(torch.zeros(2, 5), torch.zeros(2, 4),
                                 threshold_db=0.0, hysteresis_db=1.0)


class TestDetectionAdversarialTraces:
    """The traces chip_smoke.py holds the CUDA kernel to on the card
    (``k6_traces``), at small frame counts and with a small tile and
    chunk to place their edges: the plain version, the oracle and the
    reference's XLA and Pallas scans agree bitwise on them."""

    @pytest.mark.parametrize("n_rec,n_frames,min_len,capacity,block", [
        (1, 1, 1, 16, 8), (8, 31, 3, 3, 8), (13, 33, 1, 3, 4),
        (4, 64, 3, 16, 2), (13, 97, 1, 4, 8),
    ])
    @pytest.mark.parametrize("hyst", [2.0, 0.0])
    def test_plain_oracle_xla_pallas_bitwise(self, n_rec, n_frames,
                                             min_len, capacity, block,
                                             hyst):
        thr = smoke.EVENT_THRESHOLD_DB
        spl, pb = smoke.k6_traces(n_rec * 1000 + n_frames, n_rec, n_frames,
                                  tile=5, chunk=20, thr=thr, hyst=hyst)
        c, r = run_all(spl, pb, block_records=block, threshold_db=thr,
                       hysteresis_db=hyst, min_len=min_len,
                       capacity=capacity)
        if n_frames > 1:
            assert np.isnan(spl).any() and np.isposinf(spl).any()
            assert (c > 0).any()
        if n_rec >= 3:
            # record 2 holds one event open from frame 0 to the end
            assert c[2] == 1 and r[2, 0, :2].tolist() == [0.0, n_frames]
        if n_frames >= 90:
            assert (c > capacity).any()


@needs_hypothesis
class TestDetectionProperty:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**32 - 1),
           n_rec=st.integers(1, 5),
           n_frames=st.integers(1, 48),
           q=st.floats(0.05, 0.95),
           hyst=st.floats(0.0, 5.0),
           min_len=st.integers(1, 3),
           capacity=st.integers(1, 6),
           block=st.sampled_from([1, 2, 8]))
    def test_matches_reference_bitwise(self, seed, n_rec, n_frames, q,
                                       hyst, min_len, capacity, block):
        rng = np.random.default_rng(seed)
        spl = rng.standard_normal((n_rec, n_frames)).astype(np.float32) \
            * 10.0
        pb = rng.integers(0, 129, (n_rec, n_frames)).astype(np.int32)
        thr = float(np.quantile(spl, q))
        c, r = run_all(spl, pb, threshold_db=thr, hysteresis_db=hyst,
                       min_len=min_len, capacity=capacity,
                       block_records=block)
        kept = np.minimum(c, capacity)
        slot = np.arange(capacity)[None, :] < kept[:, None]
        assert not r[~slot].any()
        for i in range(n_rec):
            assert (np.diff(r[i, slot[i], 0]) > 0).all()
            assert (r[i, slot[i], 1] >= min_len).all()


# -- the detection job against the reference job ----------------------------

SHAPES = {   # name: params of the direct (set 1) and the ct shape
    "set1": dict(nfft=256, window_size=256, window_overlap=128,
                 record_size_sec=0.25),
    "ct": dict(nfft=1024, window_size=1024, window_overlap=0,
               record_size_sec=1.0),
}
DB_TOL = {"set1": 1e-3, "ct": 5e-3}
MKW = dict(n_files=2, records_per_file=4, seed=13)
THR, HYST, CAP = -40.0, 3.0, 4
BURSTS = {0: 1, 1: 2, 2: 0, 3: 3, 4: 1, 5: 6, 6: 2, 7: 1}   # 5 overflows


def _gen(p):
    """Per file: noise at -50 dB-ish and decaying tone bursts ~30 dB
    above it; record 5 holds more bursts than the capacity."""
    n_rec = MKW["records_per_file"]

    def gen(fi, n):
        rng = np.random.default_rng([MKW["seed"], fi])
        x = rng.standard_normal(n) * 0.003
        rs = p.record_size
        t = np.arange(int(0.012 * p.fs))
        f_tone = 40 * p.fs / p.nfft
        burst = 0.3 * np.exp(-t / (0.004 * p.fs)) \
            * np.sin(2 * np.pi * f_tone * t / p.fs)
        for r in range(n_rec):
            k = BURSTS[fi * n_rec + r]
            for j in range(k):
                pos = r * rs + int((j + 0.5) * rs / max(k, 1)) \
                    + int(rng.integers(0, 64))
                x[pos:pos + len(burst)] += burst[:rs * (r + 1) - pos]
        return x
    return gen


def _setup(name, root):
    kw = SHAPES[name]
    p, jp = DepamParams(**kw), JParams(**kw)
    mkw = dict(MKW, record_size=p.record_size, fs=p.fs)
    m, jm = DatasetManifest(**mkw), JManifest(**mkw)
    write_dataset(root, m, gen=_gen(p))
    return p, jp, m, jm


def _port_job(p, m, root, payload="float32", kernels=True):
    return (api.job(m, p).features("percentiles", "spd").window(records=3)
            .chunk(4).source(api.WavSource(root)).payload(payload)
            .kernels(kernels).device("cpu")
            .events(THR, hysteresis_db=HYST, capacity=CAP, impulsive=True))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Per shape: the port's and the reference's results, float32 and
    int16, over one wav corpus."""
    out = {}
    for name in SHAPES:
        root = str(tmp_path_factory.mktemp(name))
        p, jp, m, jm = _setup(name, root)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for payload in ("float32", "int16"):
                port = _port_job(p, m, root, payload).run()
                ref_ = (japi.job(jm, jp).features("percentiles", "spd")
                        .window(records=3).chunk(4)
                        .source(japi.WavSource(root)).payload(payload)
                        .events(THR, hysteresis_db=HYST, capacity=CAP,
                                impulsive=True).run())
                out[(name, payload)] = (port, ref_)
        out[name] = (p, m, root)
    return out


def _frame_db(p, m, root):
    """The port's own per-frame dB and SPL, recomputed from the wavs."""
    src = api.WavSource(root).bind(m, p)
    x = torch.as_tensor(src.fetch(np.arange(m.n_records)))
    src.close()
    fp = ops.frame_psd(x, p)
    return (spectra.db(fp, p).numpy(),
            spectra.db(fp.sum(dim=-1) * p.df, p).numpy(), fp.numpy())


@pytest.mark.parametrize("name", list(SHAPES))
def test_detection_data_is_unambiguous(jobs, name):
    """The corpus keeps every frame SPL >= 1e-2 dB from the threshold and
    the close level, and each event's peak frame and bin clear of the
    runner-up, so last-bit differences between the two packages cannot
    change an event row's integer columns."""
    p, m, root = jobs[name]
    _db, spl, fp = _frame_db(p, m, root)
    lo = np.float32(THR) - np.float32(HYST)
    assert np.abs(spl - THR).min() >= 1e-2
    assert np.abs(spl - lo).min() >= 1e-2
    ev = jobs[(name, "float32")][0].events["events"]
    for i in range(m.n_records):
        for onset, dur, pk_bin, _ in ev.record(i):
            seg = np.sort(spl[i, int(onset):int(onset + dur)])
            if len(seg) > 1:
                assert seg[-1] - seg[-2] > 1e-3
            f = int(onset) + int(np.argmax(spl[i, int(onset):
                                                  int(onset + dur)]))
            top = np.sort(fp[i, f])
            assert top[-1] > top[-2] * (1 + 1e-3)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("payload", ["float32", "int16"])
def test_matches_reference_job(jobs, name, payload):
    got, want = jobs[(name, payload)]
    assert np.max(np.abs(got["percentiles"] - want["percentiles"])) < 5e-3
    ge, we = got.events["events"], want.events["events"]
    assert np.array_equal(ge.counts, we.counts)
    assert ge.n_events > 0 and ge.overflow.any()
    assert ge.counts.tolist() == [BURSTS[i] for i in range(8)]
    assert ge.rows.shape == we.rows.shape
    assert np.array_equal(ge.rows[:, :3], we.rows[:, :3])   # exact
    assert np.max(np.abs(ge.rows[:, 3] - we.rows[:, 3])) < DB_TOL[name]
    gi, wi = got.events["impulsive"], want.events["impulsive"]
    assert np.array_equal(gi.counts, wi.counts)
    np.testing.assert_allclose(gi.rows[:, :2], wi.rows[:, :2], rtol=0,
                               atol=1e-3)                   # sel, peak dB
    np.testing.assert_allclose(gi.rows[:, 2], wi.rows[:, 2], rtol=1e-3,
                               atol=1e-3)                   # kurtosis
    p = jobs[name][0]
    np.testing.assert_allclose(gi.rows[:, 3], wi.rows[:, 3], rtol=0,
                               atol=2.0 / p.fs)             # rise time


def _spd_counts(db, m, window):
    """np.histogram of per-frame dB values per (window, frequency bin)."""
    from repro_torch.api import features as F
    edges = np.arange(F.SPD_N_DB + 1) * F.SPD_DB_STEP + F.SPD_DB_MIN
    n_win = -(-m.n_records // window)
    counts = np.zeros((n_win, db.shape[-1], F.SPD_N_DB), np.int64)
    for w in range(n_win):
        d = db[w * window:(w + 1) * window]
        for b in range(db.shape[-1]):
            counts[w, b] = np.histogram(
                d[..., b], bins=edges,
                range=(F.SPD_DB_MIN, F.SPD_DB_MAX))[0]
    return counts, edges


@pytest.mark.parametrize("name", list(SHAPES))
def test_spd_counts(jobs, name):
    """spd is exactly np.histogram of the port's own dB values; against
    the reference, counts differ only by frames within 1e-3 dB of a bin
    edge (counted)."""
    p, m, root = jobs[name]
    db = _frame_db(p, m, root)[0]
    counts, edges = _spd_counts(db.astype(np.float64), m, 3)
    total = counts.sum(axis=-1, keepdims=True)
    dens = (counts / np.where(total > 0, total * 3.0, 1.0)).astype(
        np.float32)
    got, want = jobs[(name, "float32")]
    assert np.array_equal(got["spd"], dens)
    jcounts = np.rint(want["spd"].astype(np.float64)
                      * np.where(total > 0, total * 3.0, 0.0))
    near = int(np.sum(np.min(np.abs(db[..., None] - edges), axis=-1)
                      < 1e-3))
    assert int(np.abs(jcounts - counts).sum()) <= near


@pytest.mark.parametrize("name", list(SHAPES))
def test_int16_payload_bitwise_float32(jobs, name):
    a, b = jobs[(name, "float32")][0], jobs[(name, "int16")][0]
    for k in ("percentiles", "spd"):
        assert np.array_equal(a[k], b[k]), k
    for k in ("events", "impulsive"):
        assert np.array_equal(a.events[k].counts, b.events[k].counts)
        assert np.array_equal(a.events[k].rows, b.events[k].rows)


def test_plain_path_matches_kernel_path(jobs):
    p, m, root = jobs["ct"]
    with pytest.warns(RuntimeWarning, match="capacity"):
        got = _port_job(p, m, root, kernels=False).run()
    want = jobs[("ct", "float32")][0]
    assert np.max(np.abs(got["percentiles"] - want["percentiles"])) < 5e-3
    assert np.array_equal(got.events["events"].counts,
                          want.events["events"].counts)


# -- impulsive metrics against a float64 oracle -----------------------------

M0 = DatasetManifest(n_files=3, records_per_file=4,
                     record_size=P0.record_size, fs=P0.fs, seed=11)


def make_pulses(m, p, seed=3):
    """Decaying sinusoid pings over a quiet noise floor, 1-3 per record."""
    rng = np.random.default_rng(seed)
    recs = rng.standard_normal((m.n_records, p.record_size)) \
        .astype(np.float32) * 0.01
    t = np.arange(2048)
    ping = (np.exp(-t / 400.0) * np.sin(2 * np.pi * 0.05 * t) * 5.0) \
        .astype(np.float32)
    for i in range(m.n_records):
        n_pulses = 1 + i % 3
        for k in range(n_pulses):
            pos = (p.record_size // (n_pulses + 1)) * (k + 1) \
                + int(rng.integers(-200, 200))
            end = min(pos + len(ping), p.record_size)
            recs[i, pos:end] += ping[:end - pos]
    return recs


def impulsive_oracle(x, onset, dur, p):
    x = np.asarray(x, np.float64)
    s0 = onset * p.hop
    s1 = min((onset + dur - 1) * p.hop + p.window_size, len(x))
    seg = x[s0:s1]
    e = seg * seg
    sel = 10.0 * np.log10(max(e.sum() / p.fs, 1e-30)) + p.gain_db
    peak = 10.0 * np.log10(max(e.max(), 1e-30)) + p.gain_db
    mean = seg.mean()
    m2 = ((seg - mean) ** 2).mean()
    m4 = ((seg - mean) ** 4).mean()
    return np.array([sel, peak, m4 / max(m2 * m2, 1e-30),
                     float(np.argmax(e)) / p.fs])


@pytest.mark.parametrize("kernels", [True, False], ids=["kernel", "plain"])
def test_impulsive_matches_float64_oracle(kernels):
    recs = make_pulses(M0, P0)

    def reader(idx):
        flat = idx.reshape(-1) % M0.n_records
        return recs[flat].reshape(*idx.shape, -1)

    out = (api.job(M0, P0).features("spl").chunk(4).kernels(kernels)
           .source(reader).device("cpu")
           .events(-5.0, hysteresis_db=2.0, capacity=8, impulsive=True)
           .run())
    ev, imp = out.events["events"], out.events["impulsive"]
    assert np.array_equal(ev.counts, imp.counts)
    assert ev.counts.tolist() == (1 + np.arange(M0.n_records) % 3).tolist()
    for i in range(M0.n_records):
        for row, got in zip(ev.record(i), imp.record(i)):
            want = impulsive_oracle(recs[i], int(row[0]), int(row[1]), P0)
            np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
            np.testing.assert_allclose(got[2], want[2], rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(got[3], want[3], rtol=0,
                                       atol=2.0 / P0.fs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_impulsive_on_card_under_high_matmul_precision(cuda):
    """The impulsive metrics on the card, with the process-wide float32
    matmul precision set to "high" (TF32 allowed), still within the
    float64 oracle's tolerances: the card path is K7, which uses no
    matrix product, so the setting cannot reach it."""
    recs = make_pulses(M0, P0)

    def reader(idx):
        flat = idx.reshape(-1) % M0.n_records
        return recs[flat].reshape(*idx.shape, -1)

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        out = (api.job(M0, P0).features("spl").chunk(4).source(reader)
               .device(cuda)
               .events(-5.0, hysteresis_db=2.0, capacity=8, impulsive=True)
               .run())
    finally:
        torch.set_float32_matmul_precision(before)
    ev, imp = out.events["events"], out.events["impulsive"]
    assert ev.counts.tolist() == (1 + np.arange(M0.n_records) % 3).tolist()
    for i in range(M0.n_records):
        for row, got in zip(ev.record(i), imp.record(i)):
            want = impulsive_oracle(recs[i], int(row[0]), int(row[1]), P0)
            np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
            np.testing.assert_allclose(got[2], want[2], rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(got[3], want[3], rtol=0,
                                       atol=2.0 / P0.fs)


# -- durability of the event log --------------------------------------------

EV = dict(threshold_db=-25.5, hysteresis_db=0.5, capacity=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    write_dataset(root, M0)
    return root


def ev_job(root, payload="float32"):
    return (api.job(M0, P0).features("spl").chunk(4)
            .source(api.WavSource(root)).payload(payload).device("cpu")
            .events(EV["threshold_db"], hysteresis_db=EV["hysteresis_db"],
                    capacity=EV["capacity"], impulsive=True))


def assert_logs_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k].counts, b[k].counts), k
        assert a[k].rows.shape == b[k].rows.shape, k
        assert np.array_equal(a[k].rows, b[k].rows), k


@pytest.fixture(scope="module")
def anchor(dataset):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return ev_job(dataset).run().events


def test_anchor_has_events_and_overflow(anchor):
    ev = anchor["events"]
    assert ev.n_events > 0 and ev.overflow.any()
    assert len(ev.rows) == ev.kept.sum()
    assert ev.column("duration").min() >= 1


@pytest.mark.parametrize("payload", ["float32", "int16"])
@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resumed"])
def test_store_resume_bitwise(dataset, anchor, tmp_path, payload, resume):
    d = str(tmp_path / "store")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if resume:
            ev_job(dataset, payload).to(d).limit(1).run()
            cur = FeatureStore(d).load_cursor()
            assert sorted(cur["events"]) == ["events", "impulsive"]
            assert all(v > 0 for v in cur["events"].values())
        out = ev_job(dataset, payload).to(d).run()
    assert_logs_equal(out.events, anchor)
    store = FeatureStore(d)
    for name in ("events", "impulsive"):
        counts, rows = store.load_events(name, 4)
        assert np.array_equal(counts, out.events[name].counts)
        assert np.array_equal(rows, out.events[name].rows)


@pytest.mark.parametrize("garbage", [16, 7], ids=["whole-row", "torn-row"])
def test_crash_between_write_and_commit(dataset, anchor, tmp_path, garbage):
    d = str(tmp_path / "store")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ev_job(dataset).to(d).limit(1).run()
        for name in ("events", "impulsive"):
            with open(f"{d}/{name}.events.bin", "ab") as f:
                f.write(b"\xff" * garbage)
        out = ev_job(dataset).to(d).run()
    assert_logs_equal(out.events, anchor)
    assert not np.isnan(out.events["events"].rows).any()


def test_cannot_resume_into_missing_log(dataset, tmp_path):
    d = str(tmp_path / "store")
    (api.job(M0, P0).features("spl").chunk(4).source(api.WavSource(dataset))
     .device("cpu").to(d).limit(1).run())
    with pytest.raises(ValueError, match="cannot resume"):
        ev_job(dataset).to(d).run()


def test_overflow_warns_once(dataset):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ev_job(dataset).run()
    hits = [w for w in caught if "capacity" in str(w.message)]
    assert len(hits) == 1 and hits[0].category is RuntimeWarning


def test_callback_sink_streams_event_slices(dataset, anchor):
    got = {}

    def on_events(step, indices, values):
        for name, (counts, rows) in values.items():
            got.setdefault(name, []).append((indices.copy(), counts, rows))

    sink = api.CallbackSink(lambda *a: None, on_events=on_events)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = ev_job(dataset).to(sink).run()
    assert res.events is None and res.features is None
    for name, parts in got.items():
        assert np.array_equal(np.concatenate([c for _, c, _ in parts]),
                              anchor[name].counts)
        assert np.array_equal(np.concatenate([r for _, _, r in parts]),
                              anchor[name].rows)


def test_result_lookup_and_spec_checks(anchor):
    from repro_torch.api import features as F
    res = api.JobResult(features={}, epoch={}, windows={}, window_edges={},
                        n_records=12, plan=None, events=anchor)
    assert res["events"] is anchor["events"]
    with pytest.raises(KeyError, match="or events"):
        res["nope"]
    with pytest.raises(ValueError, match="must declare columns"):
        F.FeatureSpec(name="x", shape=None, compute=None, ragged=True)
    with pytest.raises(ValueError, match="dense shape or reductions"):
        F.FeatureSpec(name="x", shape=lambda m, p: (), compute=None,
                      ragged=True, columns=("a",))
    with pytest.raises(ValueError, match="only meaningful"):
        F.FeatureSpec(name="x", shape=None, compute=None, columns=("a",))
