"""The port's job (main path) against the reference job, and its own
bitwise invariants: int16 == float32, resumed == uninterrupted, and a
store the reference committed mid-job resumes in the port."""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import pipeline as jpipeline
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro_torch import api
from repro_torch.core import pipeline
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams, PCM_DECODE_SCALE
from repro_torch.api.sources import synth_record

FEATS = ("welch", "spl", "tol", "ltsa", "minmax")
LINEAR = ("welch", "mean_welch", "ltsa", "min_welch", "max_welch")
PARAM_SET_1_KW = dict(nfft=256, window_size=256, window_overlap=128)
SHAPES = {   # name: (params, linear rel tol, dB abs tol)
    "set1": (dict(PARAM_SET_1_KW, record_size_sec=0.25), 1e-4, 1e-3),
    "ct": (dict(nfft=1024, window_size=1024, window_overlap=0,
                record_size_sec=4096 / 32768), 1e-3, 5e-3),
}
MKW = dict(n_files=3, records_per_file=4, seed=7)
WINDOW = 5          # windows [0,5) [5,10) [10,12): none is empty
SEED = 31


def _params(name):
    kw = SHAPES[name][0]
    return DepamParams(**kw), JParams(**kw)


def _manifests(p):
    kw = dict(MKW, record_size=p.record_size, fs=p.fs)
    return DatasetManifest(**kw), JManifest(**kw)


def _corpus(p, n):
    rng = np.random.default_rng(SEED)
    t = np.arange(p.record_size) / p.fs
    x = rng.standard_normal((n, p.record_size)) * 3000 \
        + 800 * np.sin(2 * np.pi * 440.0 * t)
    pcm = np.clip(np.rint(x), -32768, 32767).astype(np.int16)
    scales = (PCM_DECODE_SCALE * np.linspace(5, 15, n)).astype(np.float32)
    return pcm, scales


def _readers(p, n):
    """(float32 reader, int16 reader, scales fn) over one PCM corpus; the
    float reader is the host decode (one f32 multiply)."""
    pcm, scales = _corpus(p, n)

    def take(idx, dtype, fn):
        idx = np.asarray(idx)
        flat = idx.reshape(-1)
        out = np.zeros((flat.size, p.record_size), dtype)
        live = flat < n
        out[live] = fn(flat[live])
        return out.reshape(idx.shape + (p.record_size,))

    f32 = lambda idx: take(idx, np.float32, lambda i: pcm[i].astype(
        np.float32) * scales[i][:, None])
    i16 = lambda idx: take(idx, np.int16, lambda i: pcm[i])
    sc = lambda idx: scales[np.minimum(np.asarray(idx), n - 1)]
    return f32, i16, sc


def _source(pkg, p, n, payload):
    f32, i16, sc = _readers(p, n)
    if payload == "int16":
        return pkg.ReaderSource(i16, payload_dtype="int16", scales=sc)
    return pkg.ReaderSource(f32)


def _port_job(name, payload="float32"):
    p, _ = _params(name)
    m, _ = _manifests(p)
    return (api.job(m, p).features(*FEATS).window(records=WINDOW).chunk(4)
            .source(_source(api, p, m.n_records, payload)).device("cpu"))


def _jax_job(name, payload="float32"):
    _, jp = _params(name)
    _, jm = _manifests(jp)
    return (japi.job(jm, jp).features(*FEATS).window(records=WINDOW)
            .chunk(4).source(_source(japi, jp, jm.n_records, payload)))


@pytest.fixture(scope="module")
def jax_results():
    return {(n, pl): _jax_job(n, pl).run()
            for n in SHAPES for pl in ("float32", "int16")}


def _names(res):
    return list(res.features) + list(res.epoch) + list(res.windows)


def _bitwise(a, b):
    names = _names(a)
    assert names == _names(b)
    for k in names:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                              equal_nan=True), k


def _close(got, want, rel, db):
    for k in _names(want):
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        if k in LINEAR:
            assert np.max(np.abs(g - w) / np.abs(w)) < rel, k
        else:
            assert np.max(np.abs(g - w)) < db, k


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("payload", ["float32", "int16"])
def test_matches_reference_job(jax_results, name, payload):
    got = _port_job(name, payload).run()
    want = jax_results[(name, payload)]
    assert got.n_records == want.n_records == 12
    _close(got, want, *SHAPES[name][1:])


@pytest.mark.parametrize("name", list(SHAPES))
def test_int16_payload_bitwise_float32(name):
    _bitwise(_port_job(name, "float32").run(), _port_job(name, "int16").run())


@pytest.mark.parametrize("name", list(SHAPES))
def test_resume_bitwise_uninterrupted(name, tmp_path):
    full = _port_job(name).run()
    store = str(tmp_path / "store")
    _port_job(name).to(store).limit(1).run()
    j = _port_job(name, "int16").to(store)
    assert j.resume_step() == 1
    _bitwise(full, j.run())


def test_reference_store_resumes_in_port(jax_results, tmp_path):
    """A store the JAX job committed after one step resumes in the port:
    the rows written before the 'crash' stay byte-identical, and the
    finished result is within tolerance of the JAX uninterrupted run."""
    store = str(tmp_path / "store")
    _jax_job("set1").to(store).limit(1).run()
    before = {k: np.load(f"{store}/{k}.npy") for k in ("welch", "spl",
                                                       "tol")}
    j = _port_job("set1").to(store)
    assert j.resume_step() == 1
    got = j.run()
    for k, arr in before.items():
        assert np.array_equal(np.asarray(got[k])[:4], arr[:4]), k
    _close(got, jax_results[("set1", "float32")], *SHAPES["set1"][1:])


def test_run_pipeline():
    p, jp = _params("set1")
    m, jm = _manifests(p)
    f32, _i16, _sc = _readers(p, m.n_records)
    got = pipeline.run_pipeline(m, p, chunk_records=4, reader=f32,
                                device="cpu")
    want = jpipeline.run_pipeline(jm, jp, chunk_records=4, reader=f32)
    for k in ("welch", "mean_welch"):
        assert np.max(np.abs(got[k] - want[k]) / np.abs(want[k])) < 1e-4
    for k in ("ltsa_db", "spl", "tol"):
        assert np.max(np.abs(got[k] - want[k])) < 1e-3
    res = (api.job(m, p).features("welch", "spl", "tol").chunk(4)
           .source(f32).device("cpu").run())
    assert np.array_equal(got["welch"], res["welch"])
    assert got["n_records"] == m.n_records


def test_kernel_and_plain_paths_agree():
    p, _ = _params("ct")
    m, _ = _manifests(p)
    f32, _i16, _sc = _readers(p, m.n_records)
    a = api.job(m, p).chunk(4).source(f32).device("cpu").run()
    b = (api.job(m, p).chunk(4).source(f32).device("cpu").kernels(False)
         .run())
    _close(a, b, 1e-3, 5e-3)


def test_synth_source_deterministic_per_record():
    p, _ = _params("set1")
    m, _ = _manifests(p)
    a, b = synth_record(5, m, "cpu"), synth_record(5, m, "cpu")
    assert torch.equal(a, b) and a.shape == (p.record_size,)
    assert not torch.equal(a, synth_record(6, m, "cpu"))
    other = DatasetManifest(**dict(MKW, seed=8, record_size=p.record_size,
                                   fs=p.fs))
    assert not torch.equal(a, synth_record(5, other, "cpu"))
    r1 = api.job(m, p).chunk(4).device("cpu").run()
    r2 = api.job(m, p).chunk(3).device("cpu").run()
    _bitwise(api.job(m, p).chunk(4).device("cpu").run(), r1)
    # the records are the same bits; the chunking may change the last
    # bits of a batched CPU product
    np.testing.assert_allclose(r1["welch"], r2["welch"], rtol=1e-5)
    assert np.isfinite(r1["tol"]).all()


def test_empty_window_publishes_nan():
    p, _ = _params("set1")
    m = DatasetManifest.from_files((3, 0, 2), record_size=p.record_size,
                                   fs=p.fs)
    f32, _i16, _sc = _readers(p, m.n_records)
    res = (api.job(m, p).features("welch", "ltsa").window(per_file=True)
           .chunk(2).source(f32).device("cpu").run())
    assert res["ltsa"].shape == (3, p.n_bins)
    assert np.isnan(res["ltsa"][1]).all()
    assert np.isfinite(res["ltsa"][[0, 2]]).all()


def test_builder_refusals(tmp_path):
    p, _ = _params("set1")
    m, _ = _manifests(p)
    with pytest.raises(ValueError, match="device-synthesized"):
        api.job(m, p).payload("int16").device("cpu").run()
    with pytest.raises(KeyError, match="registered"):
        api.job(m, p).features("no_such_feature").device("cpu").run()
    store = str(tmp_path / "s")
    _port_job("set1").to(store).limit(1).run()
    with pytest.raises(ValueError, match="cannot resume"):
        (api.job(m, p).features("welch", "spl", "tol").chunk(4)
         .source(_readers(p, m.n_records)[0]).device("cpu").to(store).run())


def test_reference_sharded_store_resumes_in_record_order(tmp_path):
    """A store the reference committed after 2 steps of a ``.shards(4)``
    job resumes in the port under ``.shards(4)``: the event log comes
    back in record order, its onset, duration and peak bin equal, row
    for row, to the reference's uninterrupted ``.shards(4)`` run, and
    its peak dB within the SPL tolerance (the append-ordered log of a
    partitioned plan goes through ``reorder_event_rows``)."""
    from repro.data.wavio import write_dataset

    kw = dict(PARAM_SET_1_KW, record_size_sec=0.5)
    p, jp = DepamParams(**kw), JParams(**kw)
    files = (3, 6, 3, 4, 4)
    m = DatasetManifest.from_files(files, record_size=p.record_size,
                                   fs=p.fs, seed=3)
    jm = JManifest.from_files(files, record_size=jp.record_size,
                              fs=jp.fs, seed=3)
    root = str(tmp_path / "wavs")
    write_dataset(root, jm)

    def build(pkg, mm, pp):
        return (pkg.job(mm, pp).features("welch", "spl").chunk(2)
                .kernels(False).events(threshold_db=-25.0)
                .source(pkg.WavSource(root)).shards(4))

    want = build(japi, jm, jp).run()
    store = str(tmp_path / "store")
    build(japi, jm, jp).to(store).limit(2).run()
    j = build(api, m, p).device("cpu").to(store)
    assert j.resume_step() == 2
    got = j.run()
    assert got.plan.n_shards == 4
    ge, we = got.events["events"], want.events["events"]
    assert ge.n_events == we.n_events > 0
    assert np.array_equal(ge.counts, np.asarray(we.counts))
    wr = np.asarray(we.rows)
    assert np.array_equal(ge.rows[:, :3], wr[:, :3])
    assert np.max(np.abs(ge.rows[:, 3] - wr[:, 3])) < SHAPES["set1"][2]
    assert np.max(np.abs(got["welch"] - want["welch"])
                  / np.abs(want["welch"])) < SHAPES["set1"][1]


# names of reference modules the port has not ported yet: none since the
# labeled outputs (ZarrSink, NetCDFSink, read_zarr_array) came over
UNPORTED_API: set[str] = set()


def test_public_names_match_reference():
    """``repro_torch.api`` exports every public name of ``repro.api``
    except those of modules not ported yet, and nothing else; each name
    resolves."""
    assert set(api.__all__) == set(japi.__all__) - UNPORTED_API
    assert len(api.__all__) == len(set(api.__all__))
    for name in api.__all__:
        assert getattr(api, name) is not None, name


@pytest.mark.parametrize("payload", ["float32", "int16"])
def test_instrument_equals_wav_calibration(tmp_path, payload):
    """``.instrument(inst)`` derives the WavSource gain from the
    recording chain: bitwise the job with ``WavSource(calibration=
    inst.gain)``, within the job tolerances of the reference's
    ``.instrument(inst)`` job; a calibration given twice, or an
    instrument on a source without a wav calibration seam, is refused."""
    from repro.data.wavio import write_dataset
    p, jp = _params("set1")
    m, jm = _manifests(p)
    root = str(tmp_path / "wavs")
    write_dataset(root, jm)
    inst = api.Instrument(-170.0, gain_db=12.0, vpp=2.0)
    jinst = japi.Instrument(-170.0, gain_db=12.0, vpp=2.0)

    def job(pkg, m_, p_, src):
        return (pkg.job(m_, p_).features(*FEATS).chunk(4)
                .window(records=WINDOW).source(src).payload(payload))

    got = job(api, m, p, api.WavSource(root)).instrument(inst) \
        .async_io().device("cpu").run()
    manual = job(api, m, p, api.WavSource(root, calibration=inst.gain)) \
        .device("cpu").run()
    _bitwise(got, manual)
    want = job(japi, jm, jp, japi.WavSource(root)).instrument(jinst).run()
    _close(got, want, *SHAPES["set1"][1:])
    with pytest.raises(ValueError, match="calibration"):
        job(api, m, p, api.WavSource(root, calibration=2.0)) \
            .instrument(inst).device("cpu").run()
    with pytest.raises(ValueError, match="wav-fed source"):
        api.job(m, p).instrument(inst).device("cpu").run()
    with pytest.raises(TypeError, match="Instrument"):
        api.job(m, p).instrument(-170.0)
