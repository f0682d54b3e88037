"""The benchmark's plain reference (``bench/reference/depam_ref.py``) at
small sizes on the CPU: against ``scipy.signal.welch`` and hand-built
band sums.  And what it imports: nothing of the program, the JAX package
or JAX."""
import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from reference import depam_ref as R  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _params(nfft, window, overlap, n, window_kind="hamming"):
    return R.Params(fs=32768.0, nfft=nfft, window_size=window,
                    window_overlap=overlap, record_size_sec=n / 32768.0,
                    window=window_kind)


@pytest.mark.parametrize("nfft,window,overlap", [
    (256, 256, 128), (4096, 4096, 0), (256, 192, 64), (512, 384, 288)])
@pytest.mark.parametrize("kind", ["hamming", "hann", "rect"])
def test_welch_is_scipys(nfft, window, overlap, kind):
    rng = np.random.default_rng(nfft + window)
    n = 5 * window + 37                         # a partial frame at the end
    x = rng.standard_normal(n)
    p = _params(nfft, window, overlap, n, kind)
    got = R.welch(torch.as_tensor(x), p).numpy()
    _, want = scipy.signal.welch(
        x, fs=p.fs, window="boxcar" if kind == "rect" else kind,
        nperseg=window, noverlap=overlap, nfft=nfft, detrend=False,
        scaling="density", return_onesided=True)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


def test_frame_psd_blocks_agree():
    p = _params(256, 256, 128, 40 * 128)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        p.record_size))
    whole = R.frame_psd(x, p)
    blocked = R.frame_psd(x, p, block=7)
    assert torch.equal(whole, blocked)
    assert whole.shape == ((p.record_size - 256) // 128 + 1, 129)


@pytest.mark.parametrize("nfft", [256, 4096])
def test_third_octaves_of_a_flat_spectrum_are_the_band_widths(nfft):
    """A flat PSD c integrates to c times each band's width, for every
    band that lies inside the one-sided spectrum above the DC bin (which
    covers [0, df/2) only, so a band inside it reads 3 dB more)."""
    p = _params(nfft, nfft, 0, nfft)
    c = 1e-3
    got = R.tol(torch.full((1, p.n_bins), c, dtype=torch.float64), p)[0]
    g = 10 ** 0.3
    n_lo = math.ceil(3 * math.log(10.0 / 1000) / math.log(g))
    n_hi = math.floor(3 * math.log(p.fs / 2 / 1000) / math.log(g))
    fc = 1000 * g ** (np.arange(n_lo, n_hi + 1) / 3)
    lo, hi = fc * g ** (-1 / 6), fc * g ** (1 / 6)
    inside = (hi <= p.fs / 2 + p.df / 2) & (lo >= p.df / 2)
    assert inside.sum() >= 20
    want = 10 * np.log10(c * (hi - lo))
    np.testing.assert_allclose(got.numpy()[inside], want[inside],
                               rtol=0, atol=1e-9)
    assert got.shape[0] == len(fc)


def test_band_matrix_rows_partition_the_bins_inside_the_bands():
    p = _params(4096, 4096, 0, 4096)
    m = R.band_matrix(p, "cpu").numpy()
    f = np.arange(p.n_bins) * p.df
    g = 10 ** 0.3
    first_lo = 1000 * g ** (math.ceil(3 * math.log(0.01) / math.log(g)) / 3
                            - 1 / 6)
    full = (f - p.df / 2 > first_lo) & (f + p.df / 2 < p.fs / 2 * 0.89)
    np.testing.assert_allclose(m[full].sum(axis=1), 1.0, atol=1e-12)


def test_tf32_rounding():
    one = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                        1.0 + 2 ** -10 + 2 ** -12], dtype=torch.float32)
    got = R.tf32(one).tolist()
    # ties to even, then up, then down to 10 mantissa bits
    assert got == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10]
    bits = R.tf32(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_decode_pcm():
    pcm = np.arange(-500, 500, dtype="<i2") * 30
    x = R.decode(pcm, None, "cpu")
    assert x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), pcm / 32767.0, rtol=1e-15, atol=0)
    y = R.decode(pcm, np.float32(3e-4), "cpu", "tf32")
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), pcm * float(np.float32(3e-4)),
                               rtol=1e-7, atol=0)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path
    code = ("import sys; sys.path.insert(0, {!r}); "
            "from reference import depam_ref; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=""))
    loaded = set(eval(out.stdout))
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN
