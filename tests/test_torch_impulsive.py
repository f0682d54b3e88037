"""K7, the impulsive metrics over each event's own samples, against its
plain version and a float64 oracle.

  * on the CPU: the plain version (what the wrapper runs on a CPU tensor
    and ``kernel=False`` runs anywhere) against a float64 numpy oracle
    over count 0, count = capacity, overflow, multi-frame events, an
    event clipped at the record end and one spanning the whole record,
    with the hop equal to the window and below it; the int16 payload
    against the float32 one, bitwise; the wrapper's checks of device,
    dtype and shape; the cost model's bytes;
  * on the card (``-m cuda``): the CUDA kernel against the plain version
    at the detection cell's shapes (8 x 327 680 samples, capacity 16,
    hop = window = 4096), at an overlapped set and at a record length
    that is no multiple of four: peak and rise bit for bit, SEL and
    kurtosis within ``SEL_TOL_DB`` and ``KURTOSIS_RTOL``, the int16 and
    float32 payloads bit for bit, the same bits on a second call; rows
    off a 16-byte boundary against an aligned copy; and one launch a
    step and shard row in a set-2 detection job.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_2, PCM_DECODE_SCALE, \
    DepamParams
from repro_torch.kernels import impulsive, ops, roofline as kroofline

CAP = 16
OVERLAPPED = DepamParams(nfft=1024, window_size=1024, window_overlap=768,
                         record_size_sec=(79 * 256 + 1024) / 32768.0)
UNALIGNED = DepamParams(nfft=256, window_size=256, window_overlap=156,
                        record_size_sec=5157 / 32768.0)
SMALL = {
    "hop=window": DepamParams(nfft=1024, window_size=1024, window_overlap=0,
                              record_size_sec=20 * 1024 / 32768.0),
    "hop<window": DepamParams(nfft=256, window_size=256, window_overlap=128,
                              record_size_sec=(39 * 128 + 256) / 32768.0),
    "unaligned": UNALIGNED,
}
CARD = {"set2": PARAM_SET_2, "overlapped": OVERLAPPED, "unaligned": UNALIGNED}


def pcm_batch(p, n_rec, seed):
    """int16 PCM: noise with a few loud pings per record, record 1
    clipped at full scale (ties in x^2), and per-record decode scales."""
    rng = np.random.default_rng(seed)
    n = p.record_size
    x = rng.standard_normal((n_rec, n)) * 300.0
    t = np.arange(min(2048, n))
    ping = np.exp(-t / 300.0) * np.sin(2 * np.pi * 0.03 * t) * 20000.0
    for i in range(n_rec):
        for _ in range(3):
            pos = int(rng.integers(0, n - len(t)))
            x[i, pos:pos + len(t)] += ping
    x[1, n // 3:n // 3 + 64] = 40000.0 * np.sign(rng.standard_normal(64))
    q = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
    scales = (PCM_DECODE_SCALE * rng.uniform(0.5, 2.0, n_rec)).astype(
        np.float32)
    return q, scales


def event_cases(p, n_rec, seed):
    """(counts, rows) covering the kernel's cases, one record each:
    count 0; count = capacity of one-frame events; overflow (count >
    capacity) of multi-frame events; an event clipped at the record end
    beside one spanning the whole record; the rest one- and two-frame
    events, with stale non-zero rows past each count."""
    rng = np.random.default_rng(seed)
    nf = p.frames_per_record
    counts = np.zeros(n_rec, np.int32)
    rows = np.zeros((n_rec, CAP, 4), np.float32)
    rows[..., 0] = rng.integers(0, nf, (n_rec, CAP))    # stale rows
    rows[..., 1] = rng.integers(1, 4, (n_rec, CAP))
    rows[..., 2:] = rng.standard_normal((n_rec, CAP, 2))

    def put(r, evs, count=None):
        counts[r] = len(evs) if count is None else count
        for k, (onset, dur) in enumerate(evs[:CAP]):
            rows[r, k, 0], rows[r, k, 1] = onset, dur
    put(0, [])
    put(1, [(int(f), 1) for f in np.linspace(0, nf - 1, CAP)])
    put(2, [(int(f), 3) for f in np.linspace(0, nf - 4, CAP)], count=CAP + 7)
    put(3, [(nf - 2, 5), (0, nf)])
    for r in range(4, n_rec):
        k = int(rng.integers(1, 7))
        put(r, [(int(rng.integers(0, nf - 1)), int(rng.integers(1, 3)))
                for _ in range(k)])
    return counts, rows


def oracle(x, counts, rows, p):
    """float64 numpy: (sel, peak, kurtosis, rise) per kept event, zeros
    elsewhere."""
    x = np.asarray(x, np.float64)
    out = np.zeros(rows.shape, np.float64)
    n = x.shape[-1]
    for r in range(x.shape[0]):
        for k in range(min(int(counts[r]), rows.shape[1])):
            s0 = int(rows[r, k, 0]) * p.hop
            s1 = min((int(rows[r, k, 0]) + int(rows[r, k, 1]) - 1) * p.hop
                     + p.window_size, n)
            seg = x[r, s0:s1]
            e = seg * seg
            mean = seg.mean()
            m2 = ((seg - mean) ** 2).mean()
            m4 = ((seg - mean) ** 4).mean()
            out[r, k] = (10 * np.log10(max(e.sum() / p.fs, 1e-30)) + p.gain_db,
                         10 * np.log10(max(e.max(), 1e-30)) + p.gain_db,
                         m4 / max(m2 * m2, 1e-30), np.argmax(e) / p.fs)
    return out


def inputs(p, n_rec=8, seed=5, device="cpu"):
    q, sc = pcm_batch(p, n_rec, seed)
    counts, rows = event_cases(p, n_rec, seed)
    t = lambda a: torch.as_tensor(a, device=device)
    return (t(q), t(sc), t(q.astype(np.float32) * sc[:, None]), t(counts),
            t(rows), q, sc)


# -- the plain version on the CPU --------------------------------------------

@pytest.mark.parametrize("name", list(SMALL))
def test_plain_matches_float64_oracle(name):
    p = SMALL[name]
    _q, _sc, x, counts, rows, q, sc = inputs(p)
    got = impulsive.impulsive_metrics(x, counts, rows, p).numpy()
    want = oracle(q.astype(np.float32) * sc[:, None], counts.numpy(),
                  rows.numpy(), p)
    live = np.arange(CAP)[None, :] < np.minimum(counts.numpy(), CAP)[:, None]
    assert live[1].all() and live[2].all() and not live[0].any()
    assert np.array_equal(got[~live], np.zeros_like(got[~live]))
    np.testing.assert_allclose(got[live][:, :2], want[live][:, :2], rtol=0,
                               atol=1e-3)                   # sel, peak dB
    np.testing.assert_allclose(got[live][:, 2], want[live][:, 2],
                               rtol=1e-3, atol=1e-3)         # kurtosis
    np.testing.assert_allclose(got[live][:, 3], want[live][:, 3], rtol=0,
                               atol=0.5 / p.fs)              # rise, exact
    # the clipped event and the one over the whole record
    nf = p.frames_per_record
    assert (nf - 2 + 5 - 1) * p.hop + p.window_size > p.record_size
    assert want[3, 1, 0] > want[3, 0, 0]


@pytest.mark.parametrize("name", list(SMALL))
def test_plain_int16_bitwise_float32(name):
    p = SMALL[name]
    q, sc, x, counts, rows, *_ = inputs(p, seed=9)
    a = impulsive.impulsive_metrics(q, counts, rows, p, scales=sc)
    b = impulsive.impulsive_metrics(x, counts, rows, p)
    assert torch.equal(a, b)


def test_cpu_and_kernel_false_take_the_plain_version(monkeypatch):
    p = SMALL["hop<window"]
    q, sc, x, counts, rows, *_ = inputs(p)
    want = impulsive.impulsive_metrics_plain(x, counts, rows, p)
    before = impulsive.LAUNCHES.count

    def no_build(*a, **k):
        raise AssertionError("the plain path reached the kernel library")
    monkeypatch.setattr(impulsive._build, "function", no_build)
    for kernel in (True, False):
        assert torch.equal(ops.impulsive_metrics(x, counts, rows, p,
                                                 kernel=kernel), want)
        assert torch.equal(ops.impulsive_metrics(q, counts, rows, p,
                                                 scales=sc, kernel=kernel),
                           want)
    assert impulsive.LAUNCHES.count == before
    assert ops.launch_counters()["impulsive_metrics"] is impulsive.LAUNCHES


def test_full_scale_decode_without_scales():
    p = SMALL["hop=window"]
    q, _sc, _x, counts, rows, *_ = inputs(p)
    x = q.to(torch.float32) * PCM_DECODE_SCALE
    assert torch.equal(impulsive.impulsive_metrics(q, counts, rows, p),
                       impulsive.impulsive_metrics(x, counts, rows, p))


def _bad_calls(p, q, sc, x, counts, rows):
    meta = lambda t: torch.empty_like(t, device="meta")
    yield "device", ValueError, (x, meta(counts), rows, None)
    yield "device", ValueError, (q, counts, rows, meta(sc))
    yield "dtype", TypeError, (x.double(), counts, rows, None)
    yield "dtype", TypeError, (x, counts.long(), rows, None)
    yield "dtype", TypeError, (x, counts, rows.double(), None)
    yield "dtype", ValueError, (q, counts, rows, sc.double())
    yield "dtype", ValueError, (x, counts, rows, sc)
    yield "shape", ValueError, (x[0], counts, rows, None)
    yield "shape", ValueError, (x, counts[:-1], rows, None)
    yield "shape", ValueError, (x, counts, rows[:, :-1], None)
    yield "shape", ValueError, (x, counts, rows[..., :3], None)
    yield "shape", ValueError, (q, counts, rows, sc[:-1])


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("case", range(12))
def test_wrapper_raises_on_bad_inputs(case, kernel):
    p = SMALL["hop<window"]
    q, sc, x, counts, rows, *_ = inputs(p, n_rec=5)
    what, err, args = list(_bad_calls(p, q, sc, x, counts, rows))[case]
    xx, cc, rr, ss = args
    with pytest.raises(err):
        ops.impulsive_metrics(xx, cc, rr, p, scales=ss, kernel=kernel)


def test_kernel_wrapper_refuses_a_device_not_cuda():
    """The plain version runs on any device; the kernel's wrapper takes
    a CPU tensor to the plain version and refuses any other non-CUDA
    one."""
    p = SMALL["hop<window"]
    q, sc, x, counts, rows, *_ = inputs(p, n_rec=5)
    meta = [torch.empty_like(t, device="meta") for t in (x, counts, rows)]
    assert ops.impulsive_metrics(*meta, p, kernel=False).device.type \
        == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        ops.impulsive_metrics(*meta, p)


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
@pytest.mark.parametrize("name", list(SMALL))
def test_cost_reads_the_event_samples_once(name, int16):
    """The cost's bytes: each kept event's samples at the payload's
    width (and a decode scale a record for int16), counts and rows read
    once, the output written once; its samples are those of the plain
    version's span mask."""
    p = SMALL[name]
    q, sc, x, counts, rows, *_ = inputs(p)
    n = kroofline.event_span_samples(counts, rows, p, p.record_size)
    live = torch.arange(CAP)[None, :] < torch.clamp(counts, max=CAP)[:, None]
    s0 = rows[..., 0].to(torch.int64) * p.hop
    s1 = torch.clamp((rows[..., 0].to(torch.int64) + rows[..., 1] - 1)
                     * p.hop + p.window_size, max=p.record_size)
    assert n == int(torch.where(live, s1 - s0, 0).sum()) > 0
    out = impulsive.impulsive_metrics(q if int16 else x, counts, rows, p,
                                      scales=sc if int16 else None)
    io = (counts, rows, out) + ((sc,) if int16 else ())
    cost = kroofline.impulsive_metrics_cost(n, x.shape[0], CAP, int16=int16)
    assert cost.hbm_bytes == (2 if int16 else 4) * n + sum(
        t.numel() * t.element_size() for t in io)
    assert cost.bound == "bytes"


# -- the CUDA kernel on the card ---------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD))
def test_kernel_matches_plain_on_card(cuda, name):
    p = CARD[name]
    q, sc, x, counts, rows, *_ = inputs(p, seed=21, device=cuda)
    before = impulsive.LAUNCHES.count
    got = impulsive.impulsive_metrics(x, counts, rows, p)
    got_q = impulsive.impulsive_metrics(q, counts, rows, p, scales=sc)
    again = impulsive.impulsive_metrics(x, counts, rows, p)
    want = impulsive.impulsive_metrics_plain(x, counts, rows, p)
    assert impulsive.LAUNCHES.count == before + 3
    assert torch.equal(got, got_q), "int16 != float32"
    assert torch.equal(got, again), "not the same bits twice"
    got, want = got.cpu(), want.cpu()
    live = torch.arange(CAP)[None, :] < torch.clamp(counts.cpu(),
                                                    max=CAP)[:, None]
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    assert torch.equal(want[~live], got[~live])
    g, w = got[live], want[live]
    assert torch.equal(g[:, 1], w[:, 1]), "peak"
    assert torch.equal(g[:, 3], w[:, 3]), "rise"
    assert float((g[:, 0] - w[:, 0]).abs().max()) < impulsive.SEL_TOL_DB
    rel = ((g[:, 2].double() - w[:, 2].double()).abs()
           / w[:, 2].double().abs().clamp_min(1.0))
    assert float(rel.max()) < impulsive.KURTOSIS_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_kernel_on_unaligned_rows(cuda, int16):
    """The kernel reads every row with one load path, whatever its
    alignment: a view whose rows start one element off a 16-byte
    boundary, at a record length that is a multiple of four, gives the
    bits of a contiguous, aligned copy."""
    p = OVERLAPPED
    assert p.record_size % 4 == 0
    q, sc, x, counts, rows, *_ = inputs(p, n_rec=9, device=cuda)
    src = q if int16 else x
    view = src.reshape(-1)[1:1 + 8 * p.record_size].reshape(8, -1)
    copy = view.clone()
    assert view.data_ptr() % 16 != 0 and copy.data_ptr() % 16 == 0
    kw = {"scales": sc[:8]} if int16 else {}
    got = impulsive.impulsive_metrics(view, counts[:8], rows[:8], p, **kw)
    want = impulsive.impulsive_metrics(copy, counts[:8], rows[:8], p, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_one_launch_per_step_and_shard_row(cuda, shards, monkeypatch):
    """A set-2 detection job on the card launches K7 once per step and
    shard row, and never runs the plain version."""
    p = PARAM_SET_2
    m = DatasetManifest(n_files=2, records_per_file=8,
                        record_size=p.record_size, fs=p.fs, seed=3)
    q, sc = pcm_batch(p, m.n_records, 7)
    recs = q.astype(np.float32) * sc[:, None]

    def reader(idx):
        flat = idx.reshape(-1) % m.n_records
        return recs[flat].reshape(*idx.shape, -1)

    def no_plain(*a, **k):
        raise AssertionError("the card job ran the plain version")
    monkeypatch.setattr(impulsive, "impulsive_metrics_plain", no_plain)
    chunk = 4
    counters = ops.launch_counters()
    before = counters["impulsive_metrics"].count
    res = (api.job(m, p).features("spl").chunk(chunk).shards(shards)
           .source(reader).device(cuda)
           .events(-30.0, hysteresis_db=3.0, impulsive=True).run())
    steps = -(-m.n_records // (chunk * shards))
    assert counters["impulsive_metrics"].count - before == steps * shards
    ev, imp = res.events["events"], res.events["impulsive"]
    assert ev.n_events > 0 and np.array_equal(ev.counts, imp.counts)
    assert np.isfinite(imp.rows).all()
