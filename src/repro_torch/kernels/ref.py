"""Oracles for the DEPAM kernels, over ``core.spectra`` (scipy-welch
compatible).  The kernel tests hold each kernel's plain version and the
kernel itself against these."""
from __future__ import annotations

import torch

from repro_torch.core import spectra
from repro_torch.core.windows import make_window


def frame_psd(x: torch.Tensor, p) -> torch.Tensor:
    return spectra.frame_psd(x, p)


def welch_psd(records: torch.Tensor, p) -> torch.Tensor:
    return spectra.welch_psd(records, p)


def ct_frame_psd(frames: torch.Tensor, p) -> torch.Tensor:
    """Oracle for the CT kernel: PSD of pre-framed, pre-extracted frames."""
    w = make_window(p.window, p.window_size, frames.dtype, frames.device)
    spec = torch.fft.rfft(frames * w, n=p.nfft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    scale = torch.tensor(spectra.periodogram_scale(p), dtype=frames.dtype,
                         device=frames.device)
    return power * scale * spectra.onesided_weights(p.nfft, frames.dtype,
                                                    frames.device)


def welch_mean(frame_psd_: torch.Tensor) -> torch.Tensor:
    return torch.mean(frame_psd_, dim=1)


def tol_levels(psd: torch.Tensor, band_matrix: torch.Tensor,
               p) -> torch.Tensor:
    return spectra.tol_levels(psd, band_matrix, p)
