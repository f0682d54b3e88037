"""DEPAM workflow parameters (paper Table 2.1).

The two parameter sets benchmarked in the paper:

    Parameter set 1: nfft=256,  windowOverlap=128, windowSize=256,  recordSizeInSec=60
    Parameter set 2: nfft=4096, windowOverlap=0,   windowSize=4096, recordSizeInSec=10

Dataset constants (paper §2.3.1): fs = 32768 Hz, 45-min wav files,
1807 files, 320 GB total.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np


@dataclasses.dataclass(frozen=True)
class DepamParams:
    """Parameters of the DEPAM FFT-feature chain."""

    fs: float = 32768.0
    nfft: int = 256
    window_size: int = 256          # paper: windowSize
    window_overlap: int = 128       # paper: windowOverlap
    record_size_sec: float = 60.0   # paper: recordSizeInSec
    window: Literal["hamming", "hann", "rect"] = "hamming"  # PAMGuide default
    # Calibration gain (dB) applied to levels; paper uses uncalibrated re 1uPa.
    gain_db: float = 0.0
    # Third-octave bands: IEC 61260 base-10 nominal bands within [tol_fmin, fs/2).
    tol_fmin: float = 10.0
    # Event detection (the ragged 'events'/'impulsive' features): a frame
    # opens an event when its wideband SPL reaches event_threshold_db and
    # the event closes at the first frame below threshold - hysteresis
    # (or at the record end).  Events shorter than event_min_len frames
    # are dropped; at most event_capacity rows are kept per record (the
    # TRUE count is always recorded, so overflow is detectable).  These
    # live here — not on the feature spec — so they key the compile
    # caches and same-config tenants share one program.
    event_threshold_db: float = 60.0
    event_hysteresis_db: float = 3.0
    event_min_len: int = 1
    event_capacity: int = 16

    def __post_init__(self) -> None:
        if self.window_size > self.nfft:
            raise ValueError("window_size must be <= nfft (zero-padded FFT)")
        if not 0 <= self.window_overlap < self.window_size:
            raise ValueError("window_overlap must be in [0, window_size)")
        if self.event_hysteresis_db < 0:
            raise ValueError("event_hysteresis_db must be >= 0")
        if self.event_min_len < 1:
            raise ValueError("event_min_len must be >= 1")
        if self.event_capacity < 1:
            raise ValueError("event_capacity must be >= 1")

    @property
    def hop(self) -> int:
        return self.window_size - self.window_overlap

    @property
    def record_size(self) -> int:
        """Samples per record."""
        return int(round(self.record_size_sec * self.fs))

    @property
    def frames_per_record(self) -> int:
        """Number of full analysis windows per record (no partial frames)."""
        return (self.record_size - self.window_size) // self.hop + 1

    @property
    def n_bins(self) -> int:
        """One-sided spectrum length."""
        return self.nfft // 2 + 1

    @property
    def df(self) -> float:
        return self.fs / self.nfft


# The paper's two benchmark parameter sets.
PARAM_SET_1 = DepamParams(nfft=256, window_size=256, window_overlap=128,
                          record_size_sec=60.0)
PARAM_SET_2 = DepamParams(nfft=4096, window_size=4096, window_overlap=0,
                          record_size_sec=10.0)

# int16 PCM decode factor.  Dequantization is ONE float32 multiply per
# sample by a per-record scale of PCM_DECODE_SCALE * calibration_gain,
# with the product fused in float32 on the host (data/wavio) so the
# device kernels and the host decode perform the exact same single
# rounding — that is what keeps the int16 payload path bitwise-identical
# to the float32 path.  A divide here (the obvious /32767.0) is NOT
# equivalent: XLA rewrites division-by-constant into multiplication by
# the rounded reciprocal, which diverges from a host-side divide.
PCM_DECODE_SCALE = np.float32(1.0) / np.float32(32767.0)

# Dataset constants from the paper (St-Pierre-et-Miquelon 2010 deployment).
PAPER_FS = 32768.0
PAPER_FILE_SEC = 45 * 60
PAPER_N_FILES = 1807
PAPER_TOTAL_GB = 320.0
