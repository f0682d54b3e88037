"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; those
are held against the JAX kernels in interpret mode at the shapes and
tolerances of tests/test_kernels.py, in float32 and int16.  The CUDA
kernels themselves run only on the card: the ``cuda``-marked cases
compare each with its plain version there and skip elsewhere
(``python -m pytest -m cuda tests/test_torch_kernels.py`` on the GPU;
chip_smoke.py does the same at the main path's shapes, and its K3 and K6
sweeps, which these cases take from it).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tol as jtol
from repro.core.params import DepamParams as JParams
from repro.kernels import ct_rfft as jct, framepsd as jfp, ops as jops
from repro.kernels import ref as jref, tol as jtolk, welch as jwelch
from repro_torch.core import spectra
from repro_torch.core.params import DepamParams, PCM_DECODE_SCALE
from repro_torch.core.tol import band_matrix
from repro_torch.kernels import (common, ct_rfft, events, fftplan, framepsd,
                                 ops, ref, tol as tolk, welch)


_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _p(nfft, ws, ov, n_frames=10, window="hamming"):
    hop = ws - ov
    sec = ((n_frames - 1) * hop + ws) / 32768.0
    kw = dict(nfft=nfft, window_size=ws, window_overlap=ov,
              record_size_sec=sec, window=window)
    return DepamParams(**kw), JParams(**kw)


def _maxrel(a, b, floor):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + floor)))


def _pcm(rng, shape):
    q = np.clip(np.rint(rng.standard_normal(shape) * 3000), -32768, 32767)
    return q.astype(np.int16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


class TestCommon:
    def test_dequantize_bitwise_host_decode(self):
        rng = np.random.default_rng(3)
        q = _pcm(rng, (4, 1000))
        scales = (PCM_DECODE_SCALE
                  * rng.uniform(0.5, 2.0, 4)).astype(np.float32)
        got = common.dequantize(torch.as_tensor(q), torch.as_tensor(scales))
        assert np.array_equal(got.numpy(),
                              q.astype(np.float32) * scales[:, None])
        plain = common.dequantize(torch.as_tensor(q))
        assert np.array_equal(plain.numpy(),
                              q.astype(np.float32) * PCM_DECODE_SCALE)

    def test_dft_matrices_fold_the_window(self):
        w = np.hanning(16)
        c, s = common.dft_matrices(16, 32, w, dtype=np.float64)
        f = np.random.default_rng(0).standard_normal(16)
        spec = np.fft.rfft(w * f, n=32)
        assert np.allclose(f @ c, spec.real) and np.allclose(f @ s,
                                                              spec.imag)

    def test_psd_backend(self):
        assert ops.psd_backend(_p(256, 256, 128)[0]) == "direct"
        assert ops.psd_backend(_p(4096, 4096, 0)[0]) == "ct"
        assert ops.psd_backend(_p(768, 384, 100)[0]) == "xla"
        for args in ((256, 256, 128), (4096, 4096, 0), (768, 384, 100),
                     (512, 384, 288)):
            assert ops.psd_backend(_p(*args)[0]) == \
                jops.psd_backend(_p(*args)[1])


class TestWelchPsd:
    """K1 plain version vs the Pallas fused Welch (interpret mode)."""

    @pytest.mark.parametrize("nfft,ws,ov,nrec,nf", [
        (256, 256, 128, 4, 20), (128, 128, 0, 3, 20), (256, 256, 192, 2, 20),
        (128, 128, 64, 2, 50),
    ])
    def test_f32_and_int16(self, nfft, ws, ov, nrec, nf):
        p, jp = _p(nfft, ws, ov, n_frames=nf)
        rng = np.random.default_rng(11)
        x = rng.standard_normal((nrec, p.record_size)).astype(np.float32)
        got = framepsd.welch_psd(torch.as_tensor(x), p)
        want = jfp.welch_psd(jnp.asarray(x), jp, interpret=True)
        assert got.shape == (nrec, p.n_bins)
        assert _maxrel(got, want, 1e-9) < 1e-4
        q = _pcm(rng, (nrec, p.record_size))
        sc = (PCM_DECODE_SCALE * np.linspace(0.5, 2, nrec)).astype(
            np.float32)
        got_q = framepsd.welch_psd(torch.as_tensor(q), p, torch.as_tensor(sc))
        host = framepsd.welch_psd(
            torch.as_tensor(q.astype(np.float32) * sc[:, None]), p)
        assert torch.equal(got_q, host)
        want_q = jfp.welch_psd(jnp.asarray(q), jp, interpret=True,
                               scales=jnp.asarray(sc))
        assert _maxrel(got_q, want_q, 1e-9) < 1e-4

    def test_fold_and_scale_match_reference(self):
        p, jp = _p(256, 256, 128)
        for a, b in zip(framepsd._fold_matrices(p), jfp._fold_matrices(jp)):
            assert np.array_equal(a, b)
        assert np.array_equal(framepsd._bin_scale(p, 0.25),
                              jfp._bin_scale(jp, 0.25))


class TestFramePsd:
    """K5 plain version vs the Pallas per-frame PSD (interpret mode), at
    the reference's frame-PSD tolerance (5e-4 relative)."""

    @pytest.mark.parametrize("nfft,ws,ov", [
        (256, 256, 128),      # paper set 1
        (128, 128, 0),
        (512, 384, 288),      # zero-padded fft, 75% overlap
        (256, 128, 64),       # nfft > window
    ])
    @pytest.mark.parametrize("batched", [False, True], ids=["1d", "2d"])
    def test_f32_and_int16(self, nfft, ws, ov, batched):
        p, jp = _p(nfft, ws, ov, n_frames=13)
        rng = np.random.default_rng(nfft + ov)
        shape = (3, p.record_size) if batched else (p.record_size,)
        x = rng.standard_normal(shape).astype(np.float32)
        got = framepsd.frame_psd(torch.as_tensor(x), p)
        want = jfp.frame_psd(jnp.asarray(x), jp, interpret=True)
        assert got.shape == tuple(want.shape)
        assert _maxrel(got, want, 1e-9) < 5e-4
        assert _maxrel(got, spectra.frame_psd(torch.as_tensor(x), p),
                       1e-9) < 5e-4
        q = _pcm(rng, shape)
        sc = (PCM_DECODE_SCALE * np.linspace(0.5, 2, 3)).astype(np.float32)
        sc = sc if batched else sc[1]
        got_q = framepsd.frame_psd(torch.as_tensor(q), p,
                                   torch.as_tensor(sc))
        host = q.astype(np.float32) * (sc[:, None] if batched else sc)
        assert torch.equal(got_q, framepsd.frame_psd(torch.as_tensor(host),
                                                     p))
        want_q = jfp.frame_psd(jnp.asarray(q), jp, interpret=True,
                               scales=jnp.asarray(sc))
        assert _maxrel(got_q, want_q, 1e-9) < 5e-4

    def test_plain_full_scale_decode(self):
        p, jp = _p(256, 256, 128, n_frames=5)
        q = _pcm(np.random.default_rng(4), (2, p.record_size))
        got = framepsd.frame_psd(torch.as_tensor(q), p)
        want = jfp.frame_psd(jnp.asarray(q), jp, interpret=True)
        assert _maxrel(got, want, 1e-9) < 5e-4

    def test_frames_sum_to_welch(self):
        """K5's frames averaged give K1's Welch PSD."""
        p, _ = _p(256, 256, 128, n_frames=20)
        x = torch.as_tensor(np.random.default_rng(8).standard_normal(
            (2, p.record_size)).astype(np.float32))
        assert _maxrel(framepsd.frame_psd(x, p).mean(dim=1),
                       framepsd.welch_psd(x, p), 1e-9) < 1e-5


class TestCooleyTukey:
    """K2 plain version vs the Pallas CT kernel (interpret mode)."""

    @pytest.mark.parametrize("nfft,n1", [
        (4096, 64), (4096, 32), (1024, 32), (256, 16),
    ])
    def test_f32_and_int16(self, nfft, n1):
        p, jp = _p(nfft, nfft, 0, n_frames=3)
        rng = np.random.default_rng(nfft)
        frames = rng.standard_normal((5, nfft)).astype(np.float32)
        got = ct_rfft.ct_frame_psd(torch.as_tensor(frames), p, n1=n1)
        want = jct.ct_frame_psd(jnp.asarray(frames), jp, n1=n1,
                                interpret=True)
        assert got.shape == tuple(want.shape)
        assert _maxrel(got, want, 1e-6) < 1e-3
        q = _pcm(rng, (5, nfft))
        sc = (PCM_DECODE_SCALE * np.linspace(1, 3, 5)).astype(np.float32)
        got_q = ct_rfft.ct_frame_psd(torch.as_tensor(q), p, n1=n1,
                                     scales=torch.as_tensor(sc))
        host = ct_rfft.ct_frame_psd(
            torch.as_tensor(q.astype(np.float32) * sc[:, None]), p, n1=n1)
        assert torch.equal(got_q, host)
        want_q = jct.ct_frame_psd(jnp.asarray(q), jp, n1=n1, interpret=True,
                                  scales=jnp.asarray(sc))
        assert _maxrel(got_q, want_q, 1e-6) < 1e-3

    def test_zero_padded_window(self):
        p, jp = _p(1024, 768, 0, n_frames=2)
        frames = np.random.default_rng(5).standard_normal(
            (3, 768)).astype(np.float32)
        got = ct_rfft.ct_frame_psd(torch.as_tensor(frames), p, n1=32)
        assert _maxrel(got, jref.ct_frame_psd(jnp.asarray(frames), jp),
                       1e-6) < 1e-3
        assert _maxrel(got, ref.ct_frame_psd(torch.as_tensor(frames), p),
                       1e-6) < 1e-3

    def test_constants_match_reference(self):
        p, jp = _p(4096, 4096, 0)
        for a, b in zip(ct_rfft._constants(p, 64, 64),
                        jct._constants(jp, 64, 64)):
            assert np.array_equal(a, b)


class TestFftPlan:
    """The tables the K1 and K2 wrappers hand the FFT core: the same
    Stockham passes as csrc/fft.cuh, in numpy float64, against
    np.fft.rfft, for every nfft the two kernels take (K1 128-512, K2
    256-8192)."""

    @staticmethod
    def run_plan(x, plan):
        m = len(x) // 2
        z = x[0::2] + 1j * x[1::2]
        tw = plan.twiddles[:, 0] + 1j * plan.twiddles[:, 1]
        ns, off = 1, 0
        for r in plan.radices:
            q = m // r
            j = np.arange(q)
            k = j % ns
            v = np.stack([z[j + i * q] for i in range(r)])
            v[1:] *= tw[off:off + (r - 1) * ns].reshape(r - 1, ns)[:, k]
            v = np.fft.fft(v, axis=0)
            z = np.empty(m, complex)
            for i in range(r):
                z[(j - k) * r + k + i * ns] = v[i]
            off += (r - 1) * ns
            ns *= r
        assert off == len(tw)
        kk = np.arange(m + 1)
        s = plan.split
        return (z[kk % m] * (s[:, 0] + 1j * s[:, 1])
                + np.conj(z[(m - kk) % m]) * (s[:, 2] + 1j * s[:, 3]))

    @pytest.mark.parametrize("nfft", [128, 256, 512, 1024, 2048, 4096, 8192])
    def test_passes_match_rfft(self, nfft):
        plan = fftplan.plan(nfft, dtype=np.float64)
        assert plan.radices[0] == 8 and set(plan.radices) <= {4, 8}
        assert np.prod(plan.radices) == nfft // 2
        assert plan.packed & 15 == 8
        x = np.random.default_rng(nfft).standard_normal(nfft)
        want = np.fft.rfft(x)
        got = self.run_plan(x, plan)
        assert np.max(np.abs(got - want)) < 1e-12 * np.max(np.abs(want))
        f32 = fftplan.plan(nfft)
        assert f32.radices == plan.radices
        for a, b in ((f32.twiddles, plan.twiddles), (f32.split, plan.split)):
            assert a.dtype == np.float32
            assert np.array_equal(a, b.astype(np.float32))


class TestWelchMeanAndTol:
    def test_welch_mean(self):
        fp = np.random.default_rng(17).random((5, 33, 129)).astype(
            np.float32)
        got = welch.welch_mean(torch.as_tensor(fp))
        want = jwelch.welch_mean(jnp.asarray(fp), block_records=2,
                                 chunk_frames=8, interpret=True)
        assert _maxrel(got, want, 1e-9) < 1e-5
        assert _maxrel(got, torch.mean(torch.as_tensor(fp), dim=1),
                       1e-9) < 1e-5

    @pytest.mark.parametrize("args", [(256, 256, 128), (4096, 4096, 0)])
    @pytest.mark.parametrize("kernel", [True, False])
    def test_tol_kernel(self, args, kernel):
        """ops.tol_levels: K4's plain version, or with kernel=False
        core.spectra's, against the Pallas kernel."""
        p, jp = _p(*args)
        m = band_matrix(p)
        psd = (np.random.default_rng(19).random((7, p.n_bins))
               + 1e-6).astype(np.float32)
        psd_t, m_t = torch.as_tensor(psd), torch.as_tensor(m)
        got = ops.tol_levels(psd_t, m_t, p, kernel=kernel)
        assert torch.equal(got, (tolk.tol_levels if kernel
                                 else spectra.tol_levels)(psd_t, m_t, p))
        want = jtolk.tol_levels(jnp.asarray(psd), jnp.asarray(
            jtol.band_matrix(jp)), jp, block_records=4, interpret=True)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-4


class TestOps:
    @pytest.mark.parametrize("args,tol", [
        ((256, 256, 128), 1e-4),      # direct
        ((1024, 1024, 0), 1e-3),      # ct + welch_mean
        ((768, 384, 100), 1e-4),      # plain spectra path
    ])
    @pytest.mark.parametrize("payload", ["float32", "int16"])
    @pytest.mark.parametrize("kernel", [True, False])
    def test_welch_psd_every_backend(self, args, tol, payload, kernel):
        """Every route against the reference's dispatch; kernel=False is
        core.spectra on the host-decoded records, bit for bit."""
        p, jp = _p(*args, n_frames=6)
        rng = np.random.default_rng(23)
        q = _pcm(rng, (3, p.record_size))
        sc = (PCM_DECODE_SCALE * np.array([1, 2, 3])).astype(np.float32)
        x = q.astype(np.float32) * sc[:, None]
        if payload == "int16":
            got = ops.welch_psd(torch.as_tensor(q), p,
                                scales=torch.as_tensor(sc), kernel=kernel)
            want = jops.welch_psd(jnp.asarray(q), jp, scales=jnp.asarray(sc))
        else:
            got = ops.welch_psd(torch.as_tensor(x), p, kernel=kernel)
            want = jops.welch_psd(jnp.asarray(x), jp)
        if not kernel:
            assert torch.equal(got, spectra.welch_psd(torch.as_tensor(x), p))
        assert _maxrel(got, want, 1e-9) < tol

    @pytest.mark.parametrize("payload", ["float32", "int16"])
    def test_frame_psd_direct_is_not_ported_yet(self, payload):
        """The "direct" backend of ops.frame_psd runs K5 and agrees with
        the reference's dispatch, 1-D and 2-D, float32 and int16.  The
        name dates from when this backend raised; the test kept it when
        its check changed, so its history stays in one place."""
        p, jp = _p(256, 256, 128, n_frames=9)
        assert ops.psd_backend(p) == "direct"
        rng = np.random.default_rng(6)
        for shape in ((p.record_size,), (2, p.record_size)):
            q = _pcm(rng, shape)
            sc = np.float32(2.0 * PCM_DECODE_SCALE) if len(shape) == 1 \
                else (PCM_DECODE_SCALE * np.array([1, 3])).astype(np.float32)
            if payload == "int16":
                got = ops.frame_psd(torch.as_tensor(q), p,
                                    scales=torch.as_tensor(sc))
                want = jops.frame_psd(jnp.asarray(q), jp,
                                      scales=jnp.asarray(sc))
            else:
                x = q.astype(np.float32) * (sc if len(shape) == 1
                                            else sc[:, None])
                got = ops.frame_psd(torch.as_tensor(x), p)
                want = jops.frame_psd(jnp.asarray(x), jp)
            assert got.shape == tuple(want.shape)
            assert _maxrel(got, want, 1e-9) < 5e-4

    @pytest.mark.parametrize("kernel", [True, False])
    def test_frame_psd_ct_and_plain(self, kernel):
        """kernel=False is core.spectra, bit for bit, on every route."""
        for args in ((1024, 1024, 0), (768, 384, 100)):
            p, jp = _p(*args, n_frames=4)
            x = np.random.default_rng(2).standard_normal(
                (2, p.record_size)).astype(np.float32)
            got = ops.frame_psd(torch.as_tensor(x), p, kernel=kernel)
            if not kernel:
                assert torch.equal(got, spectra.frame_psd(
                    torch.as_tensor(x), p))
            want = jops.frame_psd(jnp.asarray(x), jp)
            assert got.shape == tuple(want.shape)
            assert _maxrel(got, want, 1e-6) < 1e-3


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the card."""

    @pytest.mark.parametrize("nfft,ws,ov", [
        (128, 128, 0), (256, 256, 128), (256, 256, 192), (128, 128, 64),
        (512, 384, 288), (256, 128, 64),     # the FFT route
        (320, 320, 160),                     # the direct tile
    ])
    def test_welch_psd(self, cuda, nfft, ws, ov):
        p, _ = _p(nfft, ws, ov, n_frames=300)
        rng = np.random.default_rng(1)
        q = torch.as_tensor(_pcm(rng, (3, p.record_size)), device=cuda)
        sc = torch.full((3,), 3e-4, dtype=torch.float32, device=cuda)
        x = q.float() * sc[:, None]
        got = framepsd.welch_psd(x, p)
        assert _maxrel(got.cpu(), framepsd.welch_psd_plain(x, p).cpu(),
                       1e-9) < 1e-4
        assert torch.equal(got, framepsd.welch_psd(q, p, sc))

    @pytest.mark.parametrize("nfft,ws", [
        (1024, 1024), (2048, 2048), (4096, 4096), (8192, 8192), (1024, 768),
    ])
    def test_ct_frame_psd(self, cuda, nfft, ws):
        p, _ = _p(nfft, ws, 0, n_frames=3)
        rng = np.random.default_rng(nfft)
        q = torch.as_tensor(_pcm(rng, (7, ws)), device=cuda)
        sc = torch.linspace(1e-4, 3e-4, 7, device=cuda)
        x = q.float() * sc[:, None]
        got = ct_rfft.ct_frame_psd(x, p)
        assert _maxrel(got.cpu(), ct_rfft.ct_frame_psd_plain(x, p).cpu(),
                       1e-6) < 1e-3
        assert torch.equal(got, ct_rfft.ct_frame_psd(q, p, scales=sc))
        assert torch.equal(got, ct_rfft.ct_frame_psd(x, p, n1=16))

    @pytest.mark.parametrize("nfft,ws,ov", [
        (256, 256, 128), (128, 128, 0), (512, 384, 288),
        (256, 128, 64),                      # the FFT route
        (320, 320, 160),                     # the direct tile
    ])
    def test_frame_psd(self, cuda, nfft, ws, ov):
        p, _ = _p(nfft, ws, ov, n_frames=300)
        assert framepsd._frame_plan(p, cuda).route == (
            "direct" if nfft == 320 else "fft")
        rng = np.random.default_rng(2)
        q = torch.as_tensor(_pcm(rng, (3, p.record_size)), device=cuda)
        sc = torch.tensor([1e-4, 2e-4, 3e-4], device=cuda)
        x = q.float() * sc[:, None]
        got = framepsd.frame_psd(x, p)
        assert got.shape == (3, 300, p.n_bins)
        assert _maxrel(got.cpu(), framepsd.frame_psd_plain(x, p).cpu(),
                       1e-9) < 5e-4
        assert torch.equal(got, framepsd.frame_psd(q, p, sc))
        row = framepsd.frame_psd(x[1], p)
        assert _maxrel(row.cpu(), framepsd.frame_psd_plain(x[1], p).cpu(),
                       1e-9) < 5e-4
        assert torch.equal(got[1], row)
        assert torch.equal(row, framepsd.frame_psd(q[1], p, sc[1]))

    @pytest.mark.parametrize("seed,n_rec,n_frames,min_len,capacity", [
        (None, 9, 1000, 2, 6),               # normal noise around thr
    ] + [(i, *case) for i, case in enumerate(
        smoke.sweep_k6(events.TILE_FRAMES, events.CHUNK_FRAMES))])
    def test_detect_events(self, cuda, seed, n_rec, n_frames, min_len,
                           capacity):
        """K6 bitwise against its plain version (run on CPU copies), on
        chip_smoke.py's adversarial traces at every case of its sweep."""
        if seed is None:
            rng = np.random.default_rng(3)
            spl = (rng.standard_normal((n_rec, n_frames)) * 10).astype(
                np.float32)
            pb = rng.integers(0, 129, (n_rec, n_frames)).astype(np.int32)
            thr, hyst = 8.0, 2.5
        else:
            spl, pb = smoke.k6_traces(seed, n_rec, n_frames,
                                      events.TILE_FRAMES,
                                      events.CHUNK_FRAMES)
            thr, hyst = smoke.EVENT_THRESHOLD_DB, smoke.EVENT_HYSTERESIS_DB
        kw = dict(threshold_db=thr, hysteresis_db=hyst, min_len=min_len,
                  capacity=capacity)
        c, r = events.detect_events(torch.as_tensor(spl, device=cuda),
                                    torch.as_tensor(pb, device=cuda), **kw)
        pc, pr = events.detect_events_plain(torch.as_tensor(spl),
                                            torch.as_tensor(pb), **kw)
        assert torch.equal(c.cpu(), pc) and torch.equal(r.cpu(), pr)
        if seed is None:
            assert bool((pc > capacity).any())

    @pytest.mark.parametrize("n_bins", smoke.SWEEP_K3["bins"])
    @pytest.mark.parametrize("n_frames", smoke.SWEEP_K3["frames"])
    @pytest.mark.parametrize("n_rec", smoke.SWEEP_K3["records"])
    def test_welch_mean_and_tol(self, cuda, n_rec, n_frames, n_bins):
        """K3 at every shape of chip_smoke.py's K3 sweep, the same bits
        on a second call; and K4 on its output, with a ragged block of
        records at 13; K4 gives the same bits on every call."""
        nfft = 2 * (n_bins - 1)
        p, _ = _p(nfft, nfft, 0)
        gen = torch.Generator(cuda).manual_seed(n_rec * n_frames * n_bins)
        fp = torch.rand(n_rec, n_frames, p.n_bins, device=cuda,
                        generator=gen)
        got = welch.welch_mean(fp)
        assert _maxrel(got.cpu(), welch.welch_mean_plain(fp).cpu(),
                       1e-9) < 1e-5
        assert torch.equal(got, welch.welch_mean(fp))
        bm = torch.as_tensor(band_matrix(p), device=cuda)
        levels = tolk.tol_levels(got, bm, p)
        assert float((levels - tolk.tol_levels_plain(got, bm, p))
                     .abs().max()) < 1e-4
        assert torch.equal(levels, tolk.tol_levels(got, bm, p))
