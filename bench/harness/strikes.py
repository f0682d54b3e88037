"""Seeded inputs of the detection mix: the live pool with pile-driving
strikes on half of its records.

The pool is ``data.pcm_records``' noise and tone.  Half of its records,
drawn from the seed, come from channels near the pile: their gain is
12.04 dB lower (``STRUCK_GAIN``: a quarter of the counts, four times
the decode scale), so their noise and tone decode to the other records'
levels, and a strike fits 16 bits.  On them, a pile-driving sequence:
strikes at times drawn uniformly, the first within ``strike_every_s[1]``
of the record's start and each next one ``strike_every_s`` later (drawn
per gap), each a pulse of ``strike_ms`` at a frequency of 100-400 Hz on
a bin of the spectrum, its peak 20-30 dB above the channel's noise RMS,
its amplitude falling by ``e`` over the pulse.  A strike lands anywhere
in its frame, so it may straddle two frames or sit where the analysis
window is low; no sample clips (``strike_pool`` raises if one would).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness import data

PEAK_DB = (20.0, 30.0)          # strike peak over the channel's noise RMS
FREQ_HZ = (100.0, 400.0)
STRUCK_GAIN = 0.25              # a struck channel's counts, per count


def strike_pool(cfg: dict, seed: int, n: int, device: torch.device
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The detection stream's pool: ``n`` int16 records, a float32
    decode scale each (as ``data.live_pool``), and which records carry
    strikes."""
    pcm, scales = data.live_pool(cfg, seed, n, device)
    fs = float(cfg["fs"])
    rs = pcm.shape[1]
    pulse_n = int(round(float(cfg["strike_ms"]) * 1e-3 * fs))
    df = fs / int(cfg["nfft"])
    k_lo, k_hi = math.ceil(FREQ_HZ[0] / df), math.floor(FREQ_HZ[1] / df)
    gap_lo, gap_hi = (float(s) for s in cfg["strike_every_s"])
    noise = data.NOISE_COUNTS * STRUCK_GAIN
    rng = np.random.default_rng([int(seed), 11])
    struck = np.sort(rng.choice(n, size=n // 2, replace=False))
    t = np.arange(pulse_n) / fs
    decay = np.exp(-t / t[-1]) if pulse_n > 1 else np.ones(1)
    x = pcm[struck].astype(np.float64) * STRUCK_GAIN
    for row in x:
        at = rng.uniform(0.0, gap_hi)
        while int(round(at * fs)) + pulse_n <= rs:
            start = int(round(at * fs))
            amp = noise * 10.0 ** (rng.uniform(*PEAK_DB) / 20.0)
            freq = df * int(rng.integers(k_lo, k_hi + 1))
            row[start:start + pulse_n] += \
                amp * decay * np.sin(2 * np.pi * freq * t)
            at += rng.uniform(gap_lo, gap_hi)
    x = np.round(x)
    if np.abs(x).max() > 32767:
        raise ValueError("a strike clips 16 bits")
    pcm = pcm.copy()
    pcm[struck] = x.astype(np.int16)
    scales = scales.copy()
    scales[struck] *= np.float32(1.0 / STRUCK_GAIN)
    return pcm, scales, struck
