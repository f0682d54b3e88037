"""K3: Welch reduction, the mean over frames of per-frame PSDs.

``(n_records, n_frames, n_bins) -> (n_records, n_bins)`` with 1/n_frames
folded in.  Replaces the TPU kernel ``src/repro/kernels/welch.py:32``;
the CUDA source (``csrc/welch.cu``) says what bounds it on the card and
how its design answers.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .common import LaunchCounter, check_cuda

LAUNCHES = LaunchCounter("welch_mean")


def _inv_n(n_frames: int) -> float:
    return float(np.float32(1.0 / n_frames))


def welch_mean_plain(frame_psd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: frame sum times the f32 1/n_frames."""
    x = frame_psd.to(torch.float32)
    return x.sum(dim=1) * _inv_n(x.shape[1])


def welch_mean(frame_psd: torch.Tensor) -> torch.Tensor:
    """(n_records, n_frames, n_bins) -> (n_records, n_bins) mean."""
    if frame_psd.device.type == "cpu":
        return welch_mean_plain(frame_psd)
    check_cuda(frame_psd, "frame_psd", (torch.float32,), 3)
    x = frame_psd.contiguous()
    n_rec, n_frames, n_bins = x.shape
    out = torch.empty((n_rec, n_bins), dtype=torch.float32, device=x.device)
    fn = _build.function("depam_welch_mean", _build.P, _build.P, _build.I,
                         _build.I, _build.I, _build.F, _build.P)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), n_rec, n_frames, n_bins,
                 _inv_n(n_frames), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "welch_mean")
    LAUNCHES.hit()
    return out
