"""The port's labeled resumable sinks on the CPU (``.device("cpu")``).

The cases of the reference's ``tests/test_formats.py``: ZarrSink and
NetCDFSink equal the FeatureStore bit for bit across {sync, async} x
{fresh, resumed mid-window} x {float32, int16}, survive injected crashes
between chunk write and commit, materialize event tables with absolute
onset timestamps, refuse resumed runs under a changed instrument, and
(where the optional libraries are installed) open in xarray/zarr/
netCDF4 with a decoded time axis.  Beside them, a cross-read: each
package's ``read_zarr_array`` reads the other's Zarr group, whose
``.zarray``/``.zattrs`` metadata is the same key for key and whose
arrays agree within the job tolerances.
"""
import json
import os

import numpy as np
import pytest

from repro import api as japi
from repro.core.params import DepamParams as JParams
from repro_torch import api
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.data.wavio import write_dataset
from repro_torch.faults import FaultPlan, FaultSpec
from repro_torch.faults.errors import InjectedCrash, StoreIntegrityError

PKW = dict(nfft=256, window_size=256, window_overlap=128,
           record_size_sec=0.25)
P = DepamParams(**PKW)
COUNTS = (3, 5)
NAMES = ("site_20100603_120000.wav", "site_20100603_120200.wav")
T0 = 1275566400.0
REL, DB = 1e-4, 1e-3        # the job tolerances of tests/test_torch_job.py


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fmt_wavs")
    m = DatasetManifest.from_files(COUNTS, record_size=P.record_size,
                                   fs=P.fs, file_names=NAMES, seed=11)
    write_dataset(str(root), m)
    return str(root)


def corpus(wavs) -> DatasetManifest:
    return api.scan_dataset(wavs, P.record_size, seed=11)


def base_job(wavs, payload="float32", events=False):
    j = (api.job(corpus(wavs), P).features("welch", "spl", "ltsa")
         .chunk(2).window(records=2).source(api.WavSource(wavs))
         .device("cpu"))
    if payload != "float32":
        j = j.payload(payload)
    if events:
        j = j.events(-200.0, capacity=4)     # fires on every record
    return j


def assert_bitwise(a, b):
    for da, db in ((a.features or {}, b.features or {}),
                   (a.epoch, b.epoch), (a.windows, b.windows)):
        assert sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(np.asarray(da[k]),
                                          np.asarray(db[k]), err_msg=k)
    ea, eb = a.events or {}, b.events or {}
    assert sorted(ea) == sorted(eb)
    for k in ea:
        np.testing.assert_array_equal(ea[k].counts, eb[k].counts)
        np.testing.assert_array_equal(ea[k].rows, eb[k].rows)


_BASELINES: dict = {}


def baseline(wavs, tmp_path_factory, payload="float32", events=False):
    """One FeatureStore (StoreSink) reference run per configuration."""
    key = (payload, events)
    if key not in _BASELINES:
        d = str(tmp_path_factory.mktemp("base") / "store")
        _BASELINES[key] = base_job(wavs, payload, events).to(d).run()
    return _BASELINES[key]


def make_sink(fmt, path):
    return api.ZarrSink(path, chunk_records=2) if fmt == "zarr" \
        else api.NetCDFSink(path)


class TestBitwiseMatrix:
    """Every labeled sink leg equals the FeatureStore run bit for bit."""

    @pytest.mark.parametrize("fmt", ["zarr", "netcdf"])
    @pytest.mark.parametrize("mode", ["sync", "async"])
    @pytest.mark.parametrize("resumed", [False, True],
                             ids=["fresh", "resumed"])
    @pytest.mark.parametrize("payload", ["float32", "int16"])
    def test_matrix(self, wavs, tmp_path, tmp_path_factory,
                    fmt, mode, resumed, payload):
        path = str(tmp_path / f"out_{fmt}")

        def job():
            j = base_job(wavs, payload).to(make_sink(fmt, path))
            return j.async_io(depth=2) if mode == "async" else j

        if resumed:
            job().limit(1).run()             # partial: 1 step committed
            assert job().resume_step() == 1  # mid-window resume
        out = job().run()
        assert_bitwise(out, baseline(wavs, tmp_path_factory, payload))
        if fmt == "zarr":
            # the on-disk chunks ARE the result — re-read them raw
            np.testing.assert_array_equal(
                api.read_zarr_array(os.path.join(path, "welch")),
                out["welch"])
            np.testing.assert_array_equal(
                api.read_zarr_array(os.path.join(path, "ltsa")),
                out.windows["ltsa"])


class TestZarrLayout:
    def test_time_axis_coords_and_attrs(self, wavs, tmp_path):
        path = str(tmp_path / "z")
        out = base_job(wavs).to(make_sink("zarr", path)).run()
        m = corpus(wavs)
        np.testing.assert_allclose(
            api.read_zarr_array(os.path.join(path, "time")),
            m.record_times(np.arange(m.n_records)))
        edges = out.window_edges["ltsa"]
        np.testing.assert_allclose(
            api.read_zarr_array(os.path.join(path, "time_ltsa")),
            m.record_times(edges[:-1]))
        with open(os.path.join(path, ".zattrs")) as f:
            attrs = json.load(f)
        assert attrs["Conventions"] == "CF-1.8"
        assert attrs["time_coverage_start"] == "2010-06-03T12:00:00Z"
        assert attrs["time_coverage_gap_seconds"] \
            == pytest.approx(120.0 - COUNTS[0] * 0.25)
        with open(os.path.join(path, "time", ".zattrs")) as f:
            tat = json.load(f)
        assert tat["units"].startswith("seconds since 1970")
        assert tat["_ARRAY_DIMENSIONS"] == ["time"]

    def test_chunk_grid_is_xarray_convention(self, wavs, tmp_path):
        path = str(tmp_path / "z")
        base_job(wavs).to(api.ZarrSink(path, chunk_records=3)).run()
        with open(os.path.join(path, "welch", ".zarray")) as f:
            meta = json.load(f)
        assert meta["zarr_format"] == 2
        assert meta["chunks"] == [3, P.n_bins]
        assert meta["compressor"] is None    # raw bytes: bitwise readback
        n_chunks = -(-sum(COUNTS) // 3)
        present = [k for k in os.listdir(os.path.join(path, "welch"))
                   if not k.startswith(".")]
        assert sorted(present) == sorted(f"{i}.0" for i in range(n_chunks))

    def test_describe_reports_utc_high_watermark(self, wavs, tmp_path):
        sink = make_sink("zarr", str(tmp_path / "z"))
        base_job(wavs).to(sink).run()
        d = sink.describe()
        assert d["format"] == "zarr"
        assert d["committed_records"] == sum(COUNTS)
        # watermark = end of the LAST committed record
        assert d["committed_utc"] == api.format_utc(
            T0 + 120.0 + COUNTS[1] * 0.25)


class TestEventTables:
    @pytest.mark.parametrize("fmt", ["zarr", "netcdf"])
    def test_event_onset_timestamps(self, wavs, tmp_path,
                                    tmp_path_factory, fmt):
        path = str(tmp_path / f"ev_{fmt}")
        out = base_job(wavs, events=True).to(make_sink(fmt, path)).run()
        ref = baseline(wavs, tmp_path_factory, events=True)
        assert_bitwise(out, ref)
        log = out.events["events"]
        assert log.rows.size > 0             # the detector actually fired
        if fmt != "zarr":
            return
        rec = api.read_zarr_array(os.path.join(path, "events_record"))
        times = api.read_zarr_array(os.path.join(path, "events_time"))
        np.testing.assert_array_equal(
            api.read_zarr_array(os.path.join(path, "events_counts")),
            log.counts)
        m = corpus(wavs)
        onset = log.rows[:, log.columns.index("onset")].astype(np.float64)
        np.testing.assert_allclose(
            times, m.record_times(rec) + onset * (P.hop / m.fs))


class TestCrashAndResume:
    def test_zarr_crash_between_write_and_commit(self, wavs, tmp_path,
                                                 tmp_path_factory):
        path = str(tmp_path / "z")
        plan = FaultPlan([FaultSpec("crash_before_commit", times=1,
                                    after_visits=1)])
        with pytest.raises(InjectedCrash, match="crash_before_commit"):
            base_job(wavs).to(
                api.ZarrSink(path, chunk_records=2, faults=plan)).run()
        # chunks past the committed cursor are debris; a fresh sink
        # sweeps them and the resumed run is bitwise-identical
        out = base_job(wavs).to(make_sink("zarr", path)).run()
        assert_bitwise(out, baseline(wavs, tmp_path_factory))
        np.testing.assert_array_equal(
            api.read_zarr_array(os.path.join(path, "welch")),
            out["welch"])

    def test_netcdf_materializes_only_at_completion(self, wavs, tmp_path,
                                                    tmp_path_factory):
        path = str(tmp_path / "out.nc")
        base_job(wavs).to(make_sink("netcdf", path)).limit(1).run()
        assert not os.path.exists(path)      # killed mid-job: no .nc
        assert os.path.isdir(path + ".state")
        out = base_job(wavs).to(make_sink("netcdf", path)).run()
        assert os.path.exists(path)
        assert_bitwise(out, baseline(wavs, tmp_path_factory))

    def test_netcdf_scipy_readback(self, wavs, tmp_path):
        scipy_nc = pytest.importorskip("scipy.io")
        path = str(tmp_path / "out.nc")
        out = base_job(wavs).to(make_sink("netcdf", path)).run()
        with scipy_nc.netcdf_file(path, "r", mmap=False) as nc:
            np.testing.assert_array_equal(
                np.asarray(nc.variables["welch"][:]), out["welch"])
            np.testing.assert_allclose(
                np.asarray(nc.variables["time"][:]),
                corpus(wavs).record_times(np.arange(sum(COUNTS))))
            assert nc.Conventions == b"CF-1.8"


class TestInstrumentChain:
    INST = api.Instrument(-165.0, gain_db=6.0, vpp=2.0, name="ST #5112")

    def test_instrument_equals_manual_calibration(self, wavs):
        a = base_job(wavs).instrument(self.INST).run()
        b = (api.job(corpus(wavs), P).features("welch", "spl", "ltsa")
             .chunk(2).window(records=2)
             .source(api.WavSource(wavs, calibration=self.INST.gain))
             .device("cpu").run())
        assert_bitwise(a, b)

    def test_instrument_conflicts_with_source_calibration(self, wavs):
        j = (api.job(corpus(wavs), P).features("welch").chunk(2)
             .source(api.WavSource(wavs, calibration=2.0))
             .instrument(self.INST).device("cpu"))
        with pytest.raises(ValueError, match="calibration"):
            j.run()

    @pytest.mark.parametrize("fmt", ["zarr", "netcdf"])
    def test_resume_refuses_changed_instrument(self, wavs, tmp_path, fmt):
        path = str(tmp_path / f"i_{fmt}")
        base_job(wavs).instrument(self.INST) \
            .to(make_sink(fmt, path)).limit(1).run()
        other = api.Instrument(-180.0)
        with pytest.raises(StoreIntegrityError, match="instrument"):
            base_job(wavs).instrument(other) \
                .to(make_sink(fmt, path)).run()
        with pytest.raises(StoreIntegrityError, match="instrument"):
            base_job(wavs).to(make_sink(fmt, path)).run()   # dropped
        # the SAME instrument resumes fine
        base_job(wavs).instrument(self.INST) \
            .to(make_sink(fmt, path)).run()

    def test_instrument_attrs_in_zarr(self, wavs, tmp_path):
        path = str(tmp_path / "z")
        base_job(wavs).instrument(self.INST) \
            .to(make_sink("zarr", path)).run()
        with open(os.path.join(path, ".zattrs")) as f:
            attrs = json.load(f)
        assert attrs["instrument_sensitivity_db_re_1V_per_uPa"] == -165.0
        assert attrs["instrument_name"] == "ST #5112"


class TestOptionalLibraries:
    """Real-library readback — skips cleanly where zarr/netCDF4/xarray
    are not installed."""

    def test_xarray_opens_zarr_with_decoded_time(self, wavs, tmp_path):
        xr = pytest.importorskip("xarray")
        pytest.importorskip("zarr")
        path = str(tmp_path / "z")
        out = base_job(wavs).to(make_sink("zarr", path)).run()
        ds = xr.open_zarr(path, consolidated=False)
        np.testing.assert_array_equal(ds["welch"].values, out["welch"])
        assert ds["welch"].dims == ("time", "frequency")
        assert ds["time"].dtype.kind == "M"          # datetime64 axis
        assert str(ds["time"].values[0]).startswith("2010-06-03T12:00:00")

    def test_zarr_library_reads_our_chunks(self, wavs, tmp_path):
        zarr = pytest.importorskip("zarr")
        path = str(tmp_path / "z")
        out = base_job(wavs).to(make_sink("zarr", path)).run()
        g = zarr.open_group(path, mode="r")
        np.testing.assert_array_equal(np.asarray(g["welch"]),
                                      out["welch"])

    def test_xarray_opens_netcdf(self, wavs, tmp_path):
        xr = pytest.importorskip("xarray")
        pytest.importorskip("netCDF4")
        path = str(tmp_path / "out.nc")
        out = base_job(wavs).to(make_sink("netcdf", path)).run()
        with xr.open_dataset(path) as ds:
            np.testing.assert_array_equal(ds["welch"].values,
                                          out["welch"])
            assert ds["time"].dtype.kind == "M"


# -- across the two packages ----------------------------------------------

def _meta_files(root):
    """{relative path: parsed JSON} of every .zgroup/.zarray/.zattrs."""
    out = {}
    for d, _dirs, files in os.walk(root):
        if ".depam_state" in d:
            continue
        for f in files:
            if f in (".zgroup", ".zarray", ".zattrs"):
                with open(os.path.join(d, f)) as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = \
                        json.load(fh)
    return out


def test_zarr_groups_cross_read(wavs, tmp_path):
    """The reference and the port write the same Zarr layout: metadata
    equal key for key, and each package's ``read_zarr_array`` reads the
    other's arrays, which agree within the job tolerances (event onset,
    duration and peak bin exact)."""
    inst = api.Instrument(-165.0, gain_db=6.0, vpp=2.0, name="ST #5112")
    jinst = japi.Instrument(-165.0, gain_db=6.0, vpp=2.0, name="ST #5112")
    tz, rz = str(tmp_path / "port.zarr"), str(tmp_path / "ref.zarr")
    (base_job(wavs, events=True).instrument(inst)
     .to(api.ZarrSink(tz, chunk_records=2)).run())
    jm = japi.scan_dataset(wavs, P.record_size, seed=11)
    (japi.job(jm, JParams(**PKW)).features("welch", "spl", "ltsa")
     .chunk(2).window(records=2).source(japi.WavSource(wavs))
     .events(-200.0, capacity=4).instrument(jinst)
     .to(japi.ZarrSink(rz, chunk_records=2)).run())
    tmeta, rmeta = _meta_files(tz), _meta_files(rz)
    assert sorted(tmeta) == sorted(rmeta)
    for k in tmeta:
        assert tmeta[k] == rmeta[k], k
    arrays = sorted(os.path.dirname(k) for k in tmeta
                    if k.endswith(".zarray"))
    assert {"welch", "spl", "ltsa", "time", "time_ltsa", "frequency",
            "events_counts", "events_onset", "events_time"} <= set(arrays)
    for name in arrays:
        # port reads reference, reference reads port, and back again
        got = api.read_zarr_array(os.path.join(rz, name))
        np.testing.assert_array_equal(
            got, japi.read_zarr_array(os.path.join(rz, name)))
        mine = japi.read_zarr_array(os.path.join(tz, name))
        np.testing.assert_array_equal(
            mine, api.read_zarr_array(os.path.join(tz, name)))
        a, b = mine.astype(np.float64), got.astype(np.float64)
        if name in ("welch", "ltsa"):
            assert np.max(np.abs(a - b) / np.abs(b)) < REL, name
        elif name in ("spl", "events_peak_db"):
            assert np.max(np.abs(a - b)) < DB, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
