"""Plain reference of the DEPAM feature chain, for the benchmark's checks.

Written from the paper's definitions (Welch's method, scipy's 'density'
scaling, IEC 61260 base-10 third-octave bands), in plain PyTorch,
float64.  It decodes the 16-bit PCM it is handed itself, and works out
the window, the bands and the scales again: nothing here imports the
program.

``precision="tf32"`` is the control: the same chain with every product
of a matrix multiplication (the DFT and the band sums) taken on operands rounded to TF32 (10 mantissa bits) and accumulated in
float32, as a tensor-core matrix multiplication in TF32 computes it, and
the rest in float32.  It is the step a faster implementation would be
tempted to take, and the checks must fail it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_OCTAVE = 10.0 ** 0.3          # base-10 octave ratio (IEC 61260)


@dataclasses.dataclass(frozen=True)
class Params:
    fs: float
    nfft: int
    window_size: int
    window_overlap: int
    record_size_sec: float
    window: str = "hamming"
    tol_fmin: float = 10.0

    @property
    def hop(self) -> int:
        return self.window_size - self.window_overlap

    @property
    def record_size(self) -> int:
        return int(round(self.record_size_sec * self.fs))

    @property
    def n_bins(self) -> int:
        return self.nfft // 2 + 1

    @property
    def df(self) -> float:
        return self.fs / self.nfft


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa
    bits, ties to even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    keep = (b >> 13) & 1
    b = (b + 0x0FFF + keep) & ~0x1FFF
    return b.view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str
            ) -> torch.Tensor:
    if precision == "tf32":
        return tf32(a) @ tf32(b)       # float32 accumulation
    return a.to(torch.float64) @ b.to(torch.float64)


def _dtype(precision: str) -> torch.dtype:
    return torch.float32 if precision == "tf32" else torch.float64


# -- inputs ---------------------------------------------------------------

def decode(pcm, scale: float | None, device, precision: str = "f64"
           ) -> torch.Tensor:
    """16-bit PCM -> pressure: full scale 1/32767, times a calibration
    gain folded into ``scale`` where one is given."""
    s = 1.0 / 32767.0 if scale is None else float(scale)
    x = torch.as_tensor(np.array(pcm), device=device).to(torch.float64)
    return (x * s).to(_dtype(precision))


# -- spectra --------------------------------------------------------------

def window(p: Params, device) -> torch.Tensor:
    """Periodic window (scipy's ``get_window(..., fftbins=True)``)."""
    n = torch.arange(p.window_size, dtype=torch.float64, device=device)
    if p.window == "hamming":
        return 0.54 - 0.46 * torch.cos(2 * math.pi * n / p.window_size)
    if p.window == "hann":
        return 0.5 - 0.5 * torch.cos(2 * math.pi * n / p.window_size)
    if p.window == "rect":
        return torch.ones_like(n)
    raise ValueError(p.window)


def _dft(p: Params, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real-DFT matrices (window_size, n_bins), zero-padded to nfft."""
    j = torch.arange(p.window_size, dtype=torch.float64, device=device)
    k = torch.arange(p.n_bins, dtype=torch.float64, device=device)
    ang = 2 * math.pi * torch.outer(j, k) / p.nfft
    return torch.cos(ang), -torch.sin(ang)


def density_scale(p: Params, device) -> torch.Tensor:
    """One-sided doubling (not DC, not Nyquist for even nfft) over
    fs * sum(w^2): scipy's 'density' scaling, per bin."""
    w = window(p, device)
    s = torch.full((p.n_bins,), 2.0, dtype=torch.float64, device=device)
    s[0] = 1.0
    if p.nfft % 2 == 0:
        s[-1] = 1.0
    return s / (p.fs * float(torch.sum(w * w)))


def frame_psd(x: torch.Tensor, p: Params, precision: str = "f64",
              block: int = 1 << 14) -> torch.Tensor:
    """(n_samples,) -> (n_frames, n_bins) one-sided PSD of each full
    frame (a trailing partial frame is dropped)."""
    dt = _dtype(precision)
    dev = x.device
    c, s = _dft(p, dev)
    w = window(p, dev).to(dt)
    scale = density_scale(p, dev).to(dt)
    frames = x.to(dt).unfold(0, p.window_size, p.hop)
    out = []
    for i in range(0, frames.shape[0], block):
        f = frames[i:i + block] * w
        re, im = _matmul(f, c.to(dt), precision), _matmul(f, s.to(dt),
                                                          precision)
        out.append(((re * re + im * im) * scale).to(dt))
    return torch.cat(out)


def welch(x: torch.Tensor, p: Params, precision: str = "f64"
          ) -> torch.Tensor:
    """Welch PSD: the mean of the frames' PSDs."""
    return frame_psd(x, p, precision).mean(dim=0)


def db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=1e-30))


def spl(psd: torch.Tensor, p: Params) -> torch.Tensor:
    """Wideband level: the PSD integrated over frequency, in dB."""
    return db(psd.sum(dim=-1) * p.df)


def band_matrix(p: Params, device) -> torch.Tensor:
    """(n_bins, n_bands) share of each bin's [f - df/2, f + df/2)
    (DC: [0, df/2)) inside each IEC 61260 base-10 third-octave band
    whose nominal centre 1000 * 10^(0.1 n) lies in [tol_fmin, fs/2)."""
    n_lo = math.ceil(3.0 * math.log(p.tol_fmin / 1000.0)
                     / math.log(_OCTAVE))
    n_hi = math.floor(3.0 * math.log(p.fs / 2.0 / 1000.0)
                      / math.log(_OCTAVE))
    fc = 1000.0 * _OCTAVE ** (np.arange(n_lo, n_hi + 1) / 3.0)
    lo, hi = fc * _OCTAVE ** (-1 / 6), fc * _OCTAVE ** (1 / 6)
    f = np.arange(p.n_bins) * p.df
    b_lo = np.maximum(f - p.df / 2, 0.0)
    b_hi = f + p.df / 2
    ov = np.clip(np.minimum(b_hi[:, None], hi[None]) -
                 np.maximum(b_lo[:, None], lo[None]), 0.0, None)
    return torch.as_tensor(ov / (b_hi - b_lo)[:, None], device=device)


def tol(psd: torch.Tensor, p: Params, precision: str = "f64"
        ) -> torch.Tensor:
    """Third-octave levels (dB) of (..., n_bins) PSDs."""
    m = band_matrix(p, psd.device).to(_dtype(precision))
    return db(_matmul(psd, m, precision) * p.df)
