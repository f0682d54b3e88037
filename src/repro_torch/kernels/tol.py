"""K4: third-octave levels, banded PSD integration + dB conversion.

TOL = 10*log10(max((psd @ M) * df, 1e-30)) + gain, with M the
fractional band-membership matrix from ``core.tol``.  Replaces the TPU
kernel ``src/repro/kernels/tol.py:29``; the CUDA source
(``csrc/tol.cu``) says what bounds it on the card and how its design
answers.
"""
from __future__ import annotations

import torch

from . import _build
from .common import LaunchCounter, check_cuda

LAUNCHES = LaunchCounter("tol_levels")


def tol_levels_plain(psd: torch.Tensor, band_matrix: torch.Tensor,
                     p) -> torch.Tensor:
    """The plain PyTorch version: one f32 product, scale, log."""
    power = (psd.to(torch.float32) @ band_matrix.to(torch.float32)) * p.df
    return 10.0 * torch.log10(torch.clamp(power, min=1e-30)) + p.gain_db


def tol_levels(psd: torch.Tensor, band_matrix: torch.Tensor,
               p) -> torch.Tensor:
    """(n_records, n_bins) x (n_bins, n_bands) -> (n_records, n_bands) dB."""
    if psd.device.type == "cpu":
        return tol_levels_plain(psd, band_matrix, p)
    check_cuda(psd, "psd", (torch.float32,), 2)
    check_cuda(band_matrix, "band_matrix", (torch.float32,), 2)
    n_rec, n_bins = psd.shape
    if band_matrix.shape[0] != n_bins:
        raise ValueError(f"band_matrix has {band_matrix.shape[0]} rows for "
                         f"{n_bins} PSD bins")
    psd = psd.contiguous()
    band_matrix = band_matrix.contiguous()
    n_bands = band_matrix.shape[1]
    out = torch.empty((n_rec, n_bands), dtype=torch.float32,
                      device=psd.device)
    fn = _build.function("depam_tol_levels", _build.P, _build.P, _build.P,
                         _build.I, _build.I, _build.I, _build.F, _build.F,
                         _build.P)
    with torch.cuda.device(psd.device):
        err = fn(psd.data_ptr(), band_matrix.data_ptr(), out.data_ptr(),
                 n_rec, n_bins, n_bands, float(p.df), float(p.gain_db),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tol_levels")
    LAUNCHES.hit()
    return out
