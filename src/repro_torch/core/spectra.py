"""Plain PyTorch DEPAM feature chain (the port's oracle).

Reproduces scipy.signal.welch(x, fs, window, nperseg, noverlap, nfft,
detrend=False, scaling='density', return_onesided=True) bin for bin,
and the derived SPL / TOL / LTSA features, exactly as
``repro.core.spectra`` does.  It is what ``.kernels(False)`` runs and
what the kernels' plain versions are held against.
"""
from __future__ import annotations

import numpy as np
import torch

from .params import DepamParams
from .windows import make_window, window_power


def frame_signal(x: torch.Tensor, window_size: int, hop: int) -> torch.Tensor:
    """(..., n_samples) -> (..., n_frames, window_size); drops the tail.

    A strided view (``unfold``), not a copy."""
    return x.unfold(-1, window_size, hop)


def periodogram_scale(p: DepamParams) -> float:
    """Density scaling 1/(fs * sum(w^2)) (scipy 'density')."""
    return 1.0 / (p.fs * window_power(p.window, p.window_size))


def np_onesided_weights(nfft: int) -> np.ndarray:
    """Per-bin one-sided doubling: 2 everywhere except DC (and Nyquist
    if nfft is even)."""
    n_bins = nfft // 2 + 1
    w = np.full((n_bins,), 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    return w


def onesided_weights(nfft: int, dtype=torch.float32,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.as_tensor(np_onesided_weights(nfft), dtype=dtype,
                           device=device)


def frame_psd(x: torch.Tensor, p: DepamParams) -> torch.Tensor:
    """Per-frame one-sided PSD. (..., n_samples) -> (..., n_frames, n_bins)."""
    frames = frame_signal(x, p.window_size, p.hop)
    w = make_window(p.window, p.window_size, x.dtype, x.device)
    spec = torch.fft.rfft(frames * w, n=p.nfft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    scale = torch.tensor(periodogram_scale(p), dtype=x.dtype,
                         device=x.device)
    return power * scale * onesided_weights(p.nfft, x.dtype, x.device)


def welch_psd(x: torch.Tensor, p: DepamParams) -> torch.Tensor:
    """Welch PSD: mean of per-frame PSDs. (..., n) -> (..., n_bins)."""
    return torch.mean(frame_psd(x, p), dim=-2)


def db(power: torch.Tensor, p: DepamParams) -> torch.Tensor:
    """Power -> dB re 1 uPa: 10*log10(max(power, 1e-30)) + gain."""
    return 10.0 * torch.log10(torch.clamp(power, min=1e-30)) + p.gain_db


def spl_wideband(psd: torch.Tensor, p: DepamParams) -> torch.Tensor:
    """Wideband SPL in dB re 1 uPa: 10*log10(integral of PSD df) + gain."""
    return db(torch.sum(psd, dim=-1) * p.df, p)


def tol_levels(psd: torch.Tensor, band_matrix: torch.Tensor,
               p: DepamParams) -> torch.Tensor:
    """Third-octave levels: 10log10 of banded PSD integrals.

    band_matrix: (n_bins, n_bands) fractional membership (see core.tol).
    """
    return db((psd @ band_matrix) * p.df, p)


def record_features(record: torch.Tensor, p: DepamParams,
                    band_matrix: torch.Tensor | None = None) -> dict:
    """Full DEPAM chain for one record (or a batch of records):
    'welch' (..., n_bins), 'spl' (...,), and optionally 'tol'."""
    welch = welch_psd(record, p)
    out = {"welch": welch, "spl": spl_wideband(welch, p)}
    if band_matrix is not None:
        out["tol"] = tol_levels(welch, band_matrix, p)
    return out


def ltsa(records: torch.Tensor, p: DepamParams) -> torch.Tensor:
    """Long-Term Spectral Average: (n_records, record_size) ->
    (n_records, n_bins) in dB."""
    return db(welch_psd(records, p), p)
