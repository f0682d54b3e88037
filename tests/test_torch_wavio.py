"""The port's wav IO and metadata copies against the reference's: the
same files written, the same manifests scanned, and the same payloads
read — float32 and raw int16 — bit for bit."""
import os
import wave

import numpy as np
import pytest

from repro import api as japi
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro.data import wavio as jwavio
from repro.meta import instrument as jinstrument, timestamps as jts
from repro_torch import api
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PCM_DECODE_SCALE, DepamParams
from repro_torch.data import wavio
from repro_torch.faults.errors import BadRecordError, TruncatedRecordError
from repro_torch.meta import Instrument, format_utc, timestamps_for

PKW = dict(nfft=256, window_size=256, window_overlap=128,
           record_size_sec=0.05)
P = DepamParams(**PKW)
JP = JParams(**PKW)
MKW = dict(n_files=3, records_per_file=4, record_size=P.record_size,
           fs=P.fs, seed=5)
M = DatasetManifest(**MKW)
JM = JManifest(**MKW)
NAMES = ["site3_20100603_120000.wav", "site3_20100603_120001.wav"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same manifest written by the port and by the reference."""
    port = str(tmp_path_factory.mktemp("port"))
    ref = str(tmp_path_factory.mktemp("ref"))
    wavio.write_dataset(port, M)
    jwavio.write_dataset(ref, JM)
    return port, ref


def test_write_dataset_writes_the_reference_bytes(roots):
    port, ref = roots
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) and len(names) == M.n_files
    for n in names:
        with open(os.path.join(port, n), "rb") as a, \
                open(os.path.join(ref, n), "rb") as b:
            assert a.read() == b.read(), n


def test_write_dataset_with_generator(tmp_path):
    gen = lambda fi, n: np.sin(np.arange(n) * (0.01 + fi)) * 0.5
    paths = wavio.write_dataset(str(tmp_path / "a"), M, gen=gen)
    jpaths = jwavio.write_dataset(str(tmp_path / "b"), JM, gen=gen)
    for a, b in zip(paths, jpaths):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_scan_dataset_matches_reference(tmp_path):
    for i, name in enumerate(NAMES):
        pcm = (np.arange(P.record_size * (2 + i) + 7) % 200).astype("<i2")
        with wave.open(str(tmp_path / name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(P.fs))
            w.writeframes(pcm.tobytes())
    with pytest.warns(RuntimeWarning, match="dropping"):
        got = wavio.scan_dataset(str(tmp_path), P.record_size, seed=3)
    with pytest.warns(RuntimeWarning, match="dropping"):
        want = jwavio.scan_dataset(str(tmp_path), P.record_size, seed=3)
    for f in ("file_records", "record_size", "fs", "file_names", "seed",
              "file_starts", "file_dropped"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.n_records == 5 and got.has_timestamps


@pytest.mark.parametrize("raw", [False, True], ids=["float32", "int16"])
@pytest.mark.parametrize("calibration", [None, 2.5, "instrument"])
def test_readers_match_reference_bitwise(roots, raw, calibration):
    port, _ = roots
    cal = calibration
    jcal = calibration
    if calibration == "instrument":
        cal = Instrument(sensitivity_db=-165.0, gain_db=6.0)
        jcal = jinstrument.Instrument(sensitivity_db=-165.0, gain_db=6.0)
    idx = np.array([[11, 0, 1, 2], [5, 6, 12, -1]])
    block = wavio.BlockReader(port, M, calibration=cal, raw=raw)
    per_record = wavio.WavRecordReader(port, M, calibration=cal, raw=raw)
    jblock = jwavio.BlockReader(port, JM, calibration=jcal, raw=raw)
    got = block(idx)
    assert got.dtype == (np.int16 if raw else np.float32)
    assert got.shape == idx.shape + (M.record_size,)
    assert np.array_equal(got, per_record(idx))
    assert np.array_equal(got, jblock(idx))
    assert np.array_equal(block.scales_for(idx), jblock.scales_for(idx))
    assert not got[1, 2:].any()                 # padding slots are zero
    block.close()
    jblock.close()


@pytest.mark.parametrize("payload", ["float32", "int16"])
def test_wav_source_matches_reference_bitwise(roots, payload):
    port, _ = roots
    src = api.as_source(port).with_payload(payload).bind(M, P)
    jsrc = japi.as_source(port).with_payload(payload).bind(JM, JP)
    assert isinstance(src, api.WavSource)
    idx = np.arange(M.n_records + 2).reshape(2, -1)
    got, want = src.fetch(idx), jsrc.fetch(idx)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert np.array_equal(src.scales(idx), jsrc.scales(idx))
    if payload == "int16":
        f32 = api.WavSource(port).bind(M, P).fetch(idx)
        assert np.array_equal(f32, got.astype(np.float32)
                              * src.scales(idx)[..., None])
    src.close()
    jsrc.close()


def test_with_payload_copies_and_binds_block_reader(roots):
    port, _ = roots
    src = api.WavSource(port)
    q = src.with_payload("int16")
    assert q is not src and src.payload_dtype == "float32"
    q.bind(M, P)
    assert isinstance(q._reader, wavio.BlockReader) and q._reader.raw
    with pytest.raises(RuntimeError, match="before bind"):
        api.WavSource(port).fetch(np.arange(2))


def test_truncated_file_raises(tmp_path):
    m = DatasetManifest(n_files=1, records_per_file=2,
                        record_size=P.record_size, fs=P.fs)
    short = DatasetManifest(n_files=1, records_per_file=1,
                            record_size=P.record_size, fs=P.fs)
    wavio.write_dataset(str(tmp_path), short)
    r = wavio.BlockReader(str(tmp_path), m)
    with pytest.raises(TruncatedRecordError, match="truncated") as e:
        r(np.array([0, 1]))
    assert isinstance(e.value, ValueError) \
        and isinstance(e.value, BadRecordError) and e.value.bad_record
    r.close()


def test_meta_copies_match_reference():
    assert timestamps_for(NAMES) == jts.timestamps_for(NAMES)
    t = timestamps_for(NAMES)[0]
    assert format_utc(t) == jts.format_utc(t)
    kw = dict(sensitivity_db=-170.0, gain_db=12.0, vpp=5.0)
    assert Instrument(**kw).gain == jinstrument.Instrument(**kw).gain
    assert wavio.sidecar_scales(M, np.float32([1, 2, 3]), [0, 4, 99]) \
        .tolist() == [1.0, 2.0, float(np.float32(PCM_DECODE_SCALE))]
