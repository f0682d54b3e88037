"""Frozen cost model of the DEPAM kernel functions, and the H100's peaks.

A copy, kept with the benchmark so that no change to the program can
move it, of the idea in ``src/repro_torch/kernels/roofline.py``: the
work of one call of a kernel *function* at its shapes, independent of
how the function is implemented.

  * bytes: each input read once, at the dtype the call receives it in
    (a float32 waveform 4 bytes a sample, raw int16 PCM 2 plus a float32
    decode scale a record), and each output written once;
  * operations: an FFT's 2.5 N log2 N a frame, plus the window
    (N), and |X|^2, the density scale and the frame sum (4 a bin) --
    ``psd_flops``; a multiply-add per band-matrix non-zero and record
    for the third-octave levels, with scale, log and gain per level.

``costs/<function>.py`` maps one call's arguments to these models; the
harness adds up the cost of every call in the window.

``welch_psd`` is costed by its own inputs and outputs on every route: on
paper set 2 the program runs it as per-frame PSDs (K2) and then the
frame mean (K3), and the per-frame spectra between the two are the
implementation's own traffic, not work the function needs.  A route
that fuses them therefore reads as closer to its bound, never above it.

Peaks: NVIDIA's H100 SXM5 80GB data sheet at its 700 W limit, dense
rates: 67 TFLOP/s in float32 on the CUDA cores (the kernels use no
tensor cores) and 3.35 TB/s of HBM3.  A card set below 700 W runs
slower under load; each share is reported with the card's limit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

_BYTES = {"float32": 4, "int16": 2}


@dataclasses.dataclass(frozen=True)
class Cost:
    bytes: float
    flops: float

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def compute_s(self) -> float:
        return self.flops / F32_FLOPS_PER_S

    @property
    def bound_s(self) -> float:
        """The least time the card could take for the call."""
        return max(self.memory_s, self.compute_s)

    @property
    def bound(self) -> str:
        """What binds the call: ``"bytes"`` or ``"operations"``."""
        return "bytes" if self.memory_s >= self.compute_s else "operations"

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.bytes + other.bytes, self.flops + other.flops)


def psd_flops(nfft: int, n_bins: int) -> float:
    """One frame's one-sided PSD: window, real FFT, |X|^2, scale and
    frame sum."""
    return nfft + 2.5 * nfft * math.log2(nfft) + 4 * n_bins


def n_frames(n_samples: int, window: int, hop: int) -> int:
    return (n_samples - window) // hop + 1


def dtype_name(x) -> str:
    """The dtype a waveform tensor reaches the kernel function in."""
    return "int16" if str(x.dtype) == "torch.int16" else "float32"


def _waveform_bytes(n_records: int, n_samples: int, dtype: str) -> float:
    """A batch of records as the call receives it; raw PCM carries a
    float32 decode scale a record beside it."""
    b = _BYTES[dtype] * n_records * n_samples
    return b + (4 * n_records if dtype == "int16" else 0)


def welch_psd(n_records: int, n_samples: int, dtype: str, nfft: int,
              window: int, hop: int) -> Cost:
    """``ops.welch_psd``: (R, n) waveform -> (R, n_bins) float32."""
    bins = nfft // 2 + 1
    f = n_frames(n_samples, window, hop)
    return Cost(_waveform_bytes(n_records, n_samples, dtype)
                + 4 * n_records * bins,
                n_records * f * psd_flops(nfft, bins))


def tol_levels(n_records: int, band: np.ndarray) -> Cost:
    """``ops.tol_levels``: (R, n_bins) PSD and the (n_bins, n_bands)
    band matrix -> (R, n_bands) dB."""
    band = np.asarray(band)
    n_bins, n_bands = band.shape
    nnz = int(np.count_nonzero(band))
    return Cost(4 * (n_records * n_bins + n_bins * n_bands
                     + n_records * n_bands),
                float(2 * n_records * nnz + 3 * n_records * n_bands))
