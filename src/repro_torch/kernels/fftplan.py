"""The plan the hand-written FFT kernels follow (``csrc/fft.cuh``).

K1 (``framepsd.welch_psd``) and K2 (``ct_rfft.ct_frame_psd``) transform
a real frame of ``nfft`` samples as ``m = nfft / 2`` complex points
``z[q] = x[2q] + i x[2q+1]``: Stockham passes of radix 8 and 4, then a
split into the ``m + 1`` one-sided bins.  This module builds what the
kernels read: the pass order, the twiddles of every pass and the split
factors, in float64 and rounded once to the kernels' float32.
``tests/test_torch_kernels.py`` runs the same passes in numpy with
these tables against ``np.fft.rfft``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FftPlan:
    nfft: int
    radices: tuple[int, ...]     # pass order, first pass first
    twiddles: np.ndarray         # (n, 2): per pass (R-1, ns), re/im
    split: np.ndarray            # (m+1, 4): A re, A im, B re, B im

    @property
    def packed(self) -> int:
        """The radices as the kernels take them: 4 bits a pass, the
        first pass in the low bits."""
        return sum(r << (4 * i) for i, r in enumerate(self.radices))


def radices(m: int) -> tuple[int, ...]:
    """Radix-8 passes first, finished by one or two radix-4 passes, so
    that every pass gives each of the m/8 lanes 8 points."""
    e = m.bit_length() - 1
    if m < 64 or m != 1 << e:
        raise ValueError(f"the FFT core takes m = 2^e >= 64 points, got {m}")
    tail = {0: (), 2: (4,), 1: (4, 4)}[e % 3]
    return (8,) * ((e - 2 * len(tail)) // 3) + tail


def _unit(num: np.ndarray, den: int) -> np.ndarray:
    """exp(-2 pi i num / den) in float64, the angle reduced exactly
    first."""
    ang = 2.0 * np.pi * (np.asarray(num) % den) / den
    return np.cos(ang) - 1j * np.sin(ang)


def plan(nfft: int, dtype=np.float32) -> FftPlan:
    """The tables for a real FFT of ``nfft`` (a power of two >= 128)."""
    m = nfft // 2
    if nfft != 2 * m:
        raise ValueError(f"nfft must be even, got {nfft}")
    rs = radices(m)
    tw, ns = [], 1
    for r in rs:
        rk = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
        tw.append(_unit(rk, ns * r).reshape(-1))
        ns *= r
    tw = np.concatenate(tw)
    iw = 1j * _unit(np.arange(m + 1), nfft)
    a, b = (1 - iw) / 2, (1 + iw) / 2
    return FftPlan(
        nfft=nfft, radices=rs,
        twiddles=np.stack([tw.real, tw.imag], axis=1).astype(dtype),
        split=np.stack([a.real, a.imag, b.real, b.imag],
                       axis=1).astype(dtype))
