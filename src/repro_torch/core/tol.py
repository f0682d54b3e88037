"""Third-Octave Level (TOL) band definitions.

IEC 61260-1 base-10 nominal third-octave bands: center frequencies
f_c = 1000 * 10^(n/10) for integer band index n, band edges
f_lo = f_c * 10^(-1/20), f_hi = f_c * 10^(1/20).

The band integration is expressed as a (n_bins, n_bands) membership matrix
with fractional edge weights, so TOL = (psd @ M) * df is exact trapezoid-free
bin accounting: a PSD bin contributes the fraction of its [f-df/2, f+df/2)
support that lies inside the band.  Sum over bands of M rows is 1 for every
bin fully inside [fmin_edge, fmax_edge) — the partition-of-unity property the
tests check.
"""
from __future__ import annotations

import numpy as np

from .params import DepamParams

_G = 10.0 ** 0.3  # octave ratio, base-10 system (IEC 61260 preferred)


def band_index_range(fmin: float, fmax: float) -> tuple[int, int]:
    """Inclusive range of band indices n (f_c = 1000*G^(n/3)) whose center
    lies in [fmin, fmax)."""
    n_lo = int(np.ceil(3.0 * np.log(fmin / 1000.0) / np.log(_G)))
    n_hi = int(np.floor(3.0 * np.log(fmax / 1000.0) / np.log(_G)))
    return n_lo, n_hi


def band_centers(fmin: float, fmax: float) -> np.ndarray:
    n_lo, n_hi = band_index_range(fmin, fmax)
    n = np.arange(n_lo, n_hi + 1)
    return 1000.0 * _G ** (n / 3.0)


def band_edges(fmin: float, fmax: float) -> tuple[np.ndarray, np.ndarray]:
    fc = band_centers(fmin, fmax)
    return fc * _G ** (-1.0 / 6.0), fc * _G ** (1.0 / 6.0)


def band_matrix(p: DepamParams, dtype=np.float32) -> np.ndarray:
    """(n_bins, n_bands) fractional-membership matrix for p's FFT grid."""
    lo, hi = band_edges(p.tol_fmin, p.fs / 2.0)
    n_bands = lo.shape[0]
    freqs = np.arange(p.n_bins) * p.df
    # Each bin covers [f - df/2, f + df/2); DC covers [0, df/2).
    bin_lo = np.maximum(freqs - p.df / 2.0, 0.0)
    bin_hi = freqs + p.df / 2.0
    m = np.zeros((p.n_bins, n_bands), dtype=np.float64)
    for b in range(n_bands):
        overlap = np.minimum(bin_hi, hi[b]) - np.maximum(bin_lo, lo[b])
        m[:, b] = np.clip(overlap, 0.0, None) / (bin_hi - bin_lo)
    return m.astype(dtype)
