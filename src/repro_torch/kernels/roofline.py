"""Cost model of the port's seven CUDA kernels (K1-K7) on one H100.

The counterpart of the reference's ``kernels/roofline.py``, which models
Pallas BlockSpecs against a TPU core's VMEM; none of that carries over.
Each function here gives, for one call at the given shapes, the
function's own work, not the kernel's algorithm: ``hbm_bytes``, each
float32 input read once and each output written once, and ``flops``, an
FFT's 2.5 N log2 N operations a frame for a DFT (``psd_flops``) and
K4's band-matrix non-zeros, and for K7 the samples of the events it
is given, which only the call's counts and rows say.  These set the bound ``chip_smoke.py`` holds
each kernel's device time against.  The work is the same on every
launch route (K1 and K5's FFT route or direct tile), so the model holds
no launch plan: grids and shared memory belong to the wrappers' plans
and ``csrc/``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.distributed.roofline import HBM_BW, PEAK_FLOPS

_F32 = 4


@dataclasses.dataclass(frozen=True)
class KernelCost:
    hbm_bytes: float
    flops: float

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS[torch.float32]

    @property
    def bound(self) -> str:
        """What bounds the call: ``"bytes"`` or ``"operations"``."""
        return "bytes" if self.memory_s >= self.compute_s else "operations"

    @property
    def bound_s(self) -> float:
        """The least time the card could take for the call."""
        return max(self.memory_s, self.compute_s)


def psd_flops(n: int, n_bins: int) -> float:
    """One frame's one-sided PSD: window, a real FFT (~2.5 N log2 N),
    |X|^2 and the scale or frame sum per bin."""
    return n + 2.5 * n * math.log2(n) + 4 * n_bins


def _frames(record_size: int, p) -> int:
    return (record_size - p.window_size) // p.hop + 1


def _psd_cost(n_records: int, record_size: int, p,
              frames: bool) -> KernelCost:
    """K1 (``frames=False``) or K5 over float32 records."""
    fpr = _frames(record_size, p)
    out = n_records * (fpr if frames else 1) * p.n_bins
    return KernelCost(_F32 * (n_records * record_size + out),
                      n_records * fpr * psd_flops(p.nfft, p.n_bins))


def welch_psd_cost(n_records: int, record_size: int, p) -> KernelCost:
    """K1 ``framepsd.welch_psd``: (R, n) float32 -> (R, n_bins)."""
    return _psd_cost(n_records, record_size, p, frames=False)


def frame_psd_cost(n_records: int, record_size: int, p) -> KernelCost:
    """K5 ``framepsd.frame_psd``: (R, n) float32 -> (R, frames,
    n_bins)."""
    return _psd_cost(n_records, record_size, p, frames=True)


def ct_cost(n_frames: int, p) -> KernelCost:
    """K2 ``ct_rfft.ct_frame_psd``: (F, window) float32 -> (F, n_bins)."""
    return KernelCost(_F32 * n_frames * (p.window_size + p.n_bins),
                      n_frames * psd_flops(p.nfft, p.n_bins))


def welch_mean_cost(n_records: int, n_frames: int,
                    n_bins: int) -> KernelCost:
    """K3 ``welch.welch_mean``: (R, F, B) -> (R, B), one add a frame
    and bin."""
    n_in = n_records * n_frames * n_bins
    return KernelCost(_F32 * (n_in + n_records * n_bins), float(n_in))


def tol_cost(n_records: int, band) -> KernelCost:
    """K4 ``tol.tol_levels``: (R, n_bins) @ band (n_bins, n_bands) -> dB.
    Operations: a multiply-add per band-matrix non-zero and record, and
    scale, log and gain per level."""
    band = np.asarray(band)
    n_bins, n_bands = band.shape
    nnz = int(np.count_nonzero(band))
    return KernelCost(
        _F32 * (n_records * n_bins + n_bins * n_bands + n_records * n_bands),
        float(2 * n_records * nnz + 3 * n_records * n_bands))


def detect_events_cost(n_records: int, n_frames: int,
                       capacity: int) -> KernelCost:
    """K6 ``events.detect_events``: (R, F) float32 SPL and int32 peak
    bins -> counts (R,) int32 and rows (R, capacity, 4) float32; no
    floating-point work."""
    return KernelCost(_F32 * (2 * n_records * n_frames + n_records
                              + n_records * capacity * 4), 0.0)


def event_span_samples(counts, rows, p, record_size: int) -> int:
    """The samples K7 reads for a step's events: over each record's
    first ``min(count, capacity)`` rows, ``[onset*hop, (onset+dur-1)*hop
    + window_size)`` clipped to the record.  ``counts`` (R,) and ``rows``
    (R, capacity, 4) as ``detect_events`` gives them (any array-like)."""
    counts = np.asarray(counts).reshape(-1)
    rows = np.asarray(rows)
    cap = rows.shape[1]
    live = np.arange(cap)[None, :] < np.minimum(counts, cap)[:, None]
    onset = rows[..., 0].astype(np.int64)
    dur = rows[..., 1].astype(np.int64)
    s1 = np.minimum((onset + dur - 1) * p.hop + p.window_size, record_size)
    return int(np.sum(np.where(live, np.maximum(s1 - onset * p.hop, 0),
                               0)))


def impulsive_metrics_cost(span_samples: int, n_records: int,
                           capacity: int, int16: bool = False
                           ) -> KernelCost:
    """K7 ``impulsive.impulsive_metrics``: each event's span samples read
    once (2-byte int16 PCM and a 4-byte decode scale a record, or 4-byte
    float32), counts (R,) int32 and rows (R, capacity, 4) float32 read
    once, the (R, capacity, 4) float32 output written once.  Operations:
    a sample's x^2, x^3, x^4, its four sums and its max compare (one more
    multiply to dequantize int16); the per-slot finish is negligible."""
    sample_bytes = 2 if int16 else 4
    scales = _F32 * n_records if int16 else 0
    return KernelCost(
        sample_bytes * span_samples + scales
        + _F32 * (n_records + 2 * n_records * capacity * 4),
        float((9 if int16 else 8) * span_samples))
