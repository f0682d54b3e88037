"""The port's core (params, manifest, plans, TOL bands, windows, the
plain spectra chain, the store) against the reference package and
scipy, on the same numpy inputs."""
import numpy as np
import pytest
import scipy.signal
import torch

import jax.numpy as jnp

from repro.core import manifest as jmanifest, params as jparams
from repro.core import spectra as jspectra, tol as jtol, windows as jwindows
from repro.core.store import FeatureStore as JFeatureStore
from repro.distributed import partition as jpartition
from repro_torch.core import manifest, params, spectra, tol, windows
from repro_torch.core.store import FeatureStore
from repro_torch.distributed import partition

CASES = [  # nfft, window_size, overlap, window
    (256, 256, 128, "hamming"),     # paper set 1
    (512, 384, 288, "hann"),        # zero-padded fft, 75 % overlap
    (128, 128, 0, "rect"),
    (1024, 1024, 0, "hamming"),     # ct-shaped
]


def _p(nfft, ws, ov, window="hamming", n_frames=12):
    hop = ws - ov
    sec = ((n_frames - 1) * hop + ws) / 32768.0
    return params.DepamParams(nfft=nfft, window_size=ws, window_overlap=ov,
                              record_size_sec=sec, window=window)


def _jp(p):
    return jparams.DepamParams(**{f: getattr(p, f) for f in (
        "fs", "nfft", "window_size", "window_overlap", "record_size_sec",
        "window", "gain_db", "tol_fmin")})


def _maxrel(a, b, floor):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + floor)))


class TestCopies:
    def test_params(self):
        for a, b in ((params.PARAM_SET_1, jparams.PARAM_SET_1),
                     (params.PARAM_SET_2, jparams.PARAM_SET_2)):
            assert a.__dict__ == b.__dict__
            assert (a.hop, a.record_size, a.frames_per_record, a.n_bins,
                    a.df) == (b.hop, b.record_size, b.frames_per_record,
                              b.n_bins, b.df)
        assert params.PCM_DECODE_SCALE == jparams.PCM_DECODE_SCALE
        assert params.PCM_DECODE_SCALE.dtype == np.float32

    @pytest.mark.parametrize("p", [params.PARAM_SET_1, params.PARAM_SET_2,
                                   _p(512, 384, 288)])
    def test_band_matrix(self, p):
        assert np.array_equal(tol.band_matrix(p), jtol.band_matrix(_jp(p)))

    def test_plan_and_partition(self):
        kw = dict(record_size=64, fs=32768.0, seed=3)
        m = manifest.DatasetManifest.from_files((3, 0, 5, 2, 4), **kw)
        jm = jmanifest.DatasetManifest.from_files((3, 0, 5, 2, 4), **kw)
        a, b = manifest.plan(m, 1, 4), jmanifest.plan(jm, 1, 4)
        assert (a.n_steps, a.records_per_step) == (b.n_steps,
                                                   b.records_per_step)
        for s in range(a.n_steps):
            assert np.array_equal(a.step_indices(s), b.step_indices(s))
            assert np.array_equal(a.step_mask(s), b.step_mask(s))
            assert a.cursor_after(s) == b.cursor_after(s)
        pa = partition.build_partition(m, 3, 2)
        pb = jpartition.build_partition(jm, 3, 2)
        assert pa.offsets == pb.offsets and pa.n_steps == pb.n_steps
        for s in range(pa.n_steps):
            assert np.array_equal(pa.step_indices(s), pb.step_indices(s))
            assert pa.shard_cursors(s) == pb.shard_cursors(s)
        assert np.array_equal(pa.record_order(), pb.record_order())
        state = {"start": 0, "stop": m.n_records, "n_shards": 3,
                 "chunk_records": 2, "offsets": list(pa.offsets)}
        assert partition.plan_from_state(state).offsets == \
            jpartition.plan_from_state(state).offsets
        assert partition.adopt_plan(a, state).offsets == pa.offsets
        with pytest.raises(ValueError, match="dataset changed"):
            partition.adopt_plan(manifest.plan(m, 1, 4),
                                 dict(state, stop=99, offsets=[0, 99]))

    def test_store_reads_reference_commit(self, tmp_path):
        """The port's store copy reads what the reference's store wrote
        (and the other way round): same files, same cursor."""
        m = jmanifest.DatasetManifest(n_files=1, records_per_file=6,
                                      record_size=8, fs=1.0)
        pl = jmanifest.plan(m, 1, 2)
        agg = {"__r:epoch:x:sum": np.arange(3, dtype=np.float32),
               "__r:epoch:x:count": np.array([5], np.int32)}
        js = JFeatureStore(str(tmp_path / "a"))
        js.open_arrays({"welch": (6, 3)})["welch"][:2] = 1.5
        js.commit_state(pl, 0, agg, 2.0)
        ts = FeatureStore(str(tmp_path / "a"))
        assert ts.committed_steps(pl) == 1
        got, live = ts.load_agg()
        assert live == 2.0 and set(got) == set(agg)
        for k in agg:
            assert np.array_equal(got[k], agg[k].astype(np.float64))
        assert np.all(ts.open_arrays({"welch": (6, 3)})["welch"][:2] == 1.5)
        ts.commit_state(pl, 1, agg, 4.0)
        assert JFeatureStore(str(tmp_path / "a")).load_agg()[1] == 4.0


class TestWindows:
    @pytest.mark.parametrize("kind", ["hamming", "hann", "rect"])
    def test_matches_reference(self, kind):
        assert np.array_equal(windows.np_window(kind, 256),
                              jwindows.np_window(kind, 256))
        assert windows.window_power(kind, 100) == \
            jwindows.window_power(kind, 100)
        w = windows.make_window(kind, 64, torch.float64)
        assert w.dtype == torch.float64
        assert np.allclose(w.numpy(), scipy.signal.get_window(kind, 64))

    def test_unknown_kind(self):
        with pytest.raises(ValueError, match="unknown window"):
            windows.np_window("kaiser", 8)


class TestSpectra:
    def test_frame_signal_is_a_view_matching_reference(self):
        x = np.arange(40, dtype=np.float32).reshape(2, 20)
        got = spectra.frame_signal(torch.as_tensor(x), 8, 3)
        want = np.asarray(jspectra.frame_signal(jnp.asarray(x), 8, 3))
        assert np.array_equal(got.numpy(), want)
        assert got._is_view()

    @pytest.mark.parametrize("nfft,ws,ov,window", CASES)
    def test_chain_matches_reference(self, nfft, ws, ov, window):
        p = _p(nfft, ws, ov, window)
        rng = np.random.default_rng(nfft + ov)
        x = rng.standard_normal((3, p.record_size)).astype(np.float32)
        jp, tx, jx = _jp(p), torch.as_tensor(x), jnp.asarray(x)
        assert _maxrel(spectra.frame_psd(tx, p), jspectra.frame_psd(jx, jp),
                       1e-6) < 5e-4
        welch = spectra.welch_psd(tx, p)
        assert _maxrel(welch, jspectra.welch_psd(jx, jp), 1e-9) < 1e-4
        bm = tol.band_matrix(p)
        feats = spectra.record_features(tx, p, torch.as_tensor(bm))
        want = jspectra.record_features(jx, jp, jnp.asarray(bm))
        assert np.max(np.abs(feats["spl"].numpy()
                             - np.asarray(want["spl"]))) < 1e-3
        assert np.max(np.abs(feats["tol"].numpy()
                             - np.asarray(want["tol"]))) < 1e-3
        assert np.max(np.abs(spectra.ltsa(tx, p).numpy()
                             - np.asarray(jspectra.ltsa(jx, jp)))) < 1e-3

    @pytest.mark.parametrize("nfft,ws,ov,window", CASES)
    def test_welch_matches_scipy_float64(self, nfft, ws, ov, window):
        p = _p(nfft, ws, ov, window)
        x = np.random.default_rng(1).standard_normal(p.record_size)
        got = spectra.welch_psd(torch.as_tensor(x), p).numpy()
        _f, want = scipy.signal.welch(
            x, fs=p.fs, window=window, nperseg=ws, noverlap=ov, nfft=nfft,
            detrend=False, scaling="density", return_onesided=True)
        assert got.dtype == np.float64
        assert _maxrel(got, want, 1e-300) < 1e-10
