"""K3: Welch reduction, the mean over frames of per-frame PSDs.

``(n_records, n_frames, n_bins) -> (n_records, n_bins)`` with 1/n_frames
folded in.  Replaces the TPU kernel ``src/repro/kernels/welch.py:32``.
The CUDA kernel (``csrc/welch.cu``) spreads each (record, 32 bins) over
the warps of a block, each warp a strided set of frames with independent
partial sums, added in one fixed order; the source says what bounds it
on the card and how the design answers.  The wrapper launches from a
launch plan built once per frame count.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .common import LaunchCounter, check_cuda, launch

LAUNCHES = LaunchCounter("welch_mean")


def _inv_n(n_frames: int) -> float:
    return float(np.float32(1.0 / n_frames))


def welch_mean_plain(frame_psd: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: frame sum times the f32 1/n_frames."""
    x = frame_psd.to(torch.float32)
    return x.sum(dim=1) * _inv_n(x.shape[1])


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a K3 launch needs that depends only on the frame count: the
    entry point and the f32 1/n_frames."""
    fn: object
    inv_n: float


@functools.lru_cache(maxsize=16)
def _plan(n_frames: int) -> _Plan:
    fn = _build.function("depam_welch_mean", _build.P, _build.P, _build.I,
                         _build.I, _build.I, _build.F, _build.P)
    return _Plan(fn=fn, inv_n=_inv_n(n_frames))


def welch_mean(frame_psd: torch.Tensor) -> torch.Tensor:
    """(n_records, n_frames, n_bins) -> (n_records, n_bins) mean."""
    if frame_psd.device.type == "cpu":
        return welch_mean_plain(frame_psd)
    check_cuda(frame_psd, "frame_psd", (torch.float32,), 3)
    x = frame_psd.contiguous()
    n_rec, n_frames, n_bins = x.shape
    plan = _plan(n_frames)
    out = torch.empty((n_rec, n_bins), dtype=torch.float32, device=x.device)
    err = launch(x.device, plan.fn, x.data_ptr(), out.data_ptr(), n_rec,
                 n_frames, n_bins, plan.inv_n)
    _build.check(err, "welch_mean")
    LAUNCHES.hit()
    return out
