"""Plain reference of DEPAM's detection products, for the benchmark's
checks: the per-frame spectrogram in dB, its percentiles per bin, the
spectral probability density (SPD) of a window of records, the loud
events over the per-frame wideband level and the impulsive metrics of
each event.

Written from the definitions (pypam's ``compute_spd``, its loud-event
detector and pile-driving metrics; numpy's ``linear`` percentiles), in
plain PyTorch, float64, on the spectra of ``depam_ref`` and nothing of
the program.  ``precision="tf32"`` is the control: every matrix product
(the DFT, and the sums over an event's samples) on operands rounded to
TF32 and accumulated in float32, the rest in float32; with
``spd_counts(..., chunk=k)`` its window histogram is kept in bfloat16,
a step of ``k`` records at a time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import depam_ref as R

PERCENTILES = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
# the SPD's dB bins (pypam compute_spd): [-120, 60) in steps of 3 dB;
# levels outside are not counted
SPD_DB_MIN, SPD_DB_MAX, SPD_DB_STEP = -120.0, 60.0, 3.0
SPD_N_DB = 60


def frame_db(x: torch.Tensor, p: R.Params, precision: str = "f64"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_samples,) -> the (frames, bins) PSD of each frame and its dB."""
    psd = R.frame_psd(x, p, precision)
    return psd, R.db(psd)


def percentiles(fdb: torch.Tensor) -> torch.Tensor:
    """(frames, bins) dB -> (7, bins): numpy's ``linear`` method along
    the frames."""
    srt = torch.sort(fdb, dim=0).values
    n = srt.shape[0]
    out = []
    for q in PERCENTILES:
        pos = q / 100.0 * (n - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, n - 1)
        out.append(srt[lo] + (srt[hi] - srt[lo]) * (pos - lo))
    return torch.stack(out)


def spd_counts(fdb: torch.Tensor) -> torch.Tensor:
    """(frames, bins) dB -> (bins, 60) int64 counts of the frames in each
    3-dB bin."""
    n_bins = fdb.shape[1]
    k = torch.floor((fdb.double() - SPD_DB_MIN) / SPD_DB_STEP).long()
    ok = (fdb >= SPD_DB_MIN) & (fdb < SPD_DB_MAX)
    freq = torch.arange(n_bins, device=fdb.device).expand_as(k)
    ids = (freq * SPD_N_DB + k)[ok]
    return torch.bincount(ids, minlength=n_bins * SPD_N_DB).reshape(
        n_bins, SPD_N_DB)


def spd_density(counts: torch.Tensor) -> torch.Tensor:
    """(bins, 60) counts -> the density over dB per frequency bin (rows
    integrate to 1; a bin with no counted frame is 0)."""
    c = counts.double()
    total = c.sum(dim=-1, keepdim=True)
    return c / torch.where(total > 0, total * SPD_DB_STEP,
                           torch.ones_like(total))


def bf16_window(counts: list[torch.Tensor], chunk: int) -> torch.Tensor:
    """The control's window histogram: the records' counts added a step
    of ``chunk`` records at a time into a bfloat16 running sum."""
    acc = torch.zeros(counts[0].shape, dtype=torch.bfloat16,
                      device=counts[0].device)
    for i in range(0, len(counts), chunk):
        step = torch.stack(counts[i:i + chunk]).sum(dim=0)
        acc = (acc.float() + step.float()).to(torch.bfloat16)
    return acc.double()


def frame_spl(psd: torch.Tensor, p: R.Params) -> torch.Tensor:
    """(frames, bins) PSD -> each frame's wideband level, dB."""
    return R.db(psd.sum(dim=-1) * p.df)


def events(spl: np.ndarray, peak_bin: np.ndarray, threshold_db: float,
           hysteresis_db: float, min_len: int) -> list[tuple]:
    """Schmitt trigger over one record's frame levels: an event opens at
    the first frame at or above the threshold, closes at the first
    frame below threshold - hysteresis (or at the record's end), and is
    kept if it lasts ``min_len`` frames or more.  Rows ``(onset,
    frames, peak bin, peak dB)``, the peak the first loudest frame."""
    out, start = [], None
    lo = threshold_db - hysteresis_db
    for f, s in enumerate(list(spl) + [-math.inf]):
        if start is not None and (s < lo or f == len(spl)):
            if f - start >= min_len:
                pk = start + int(np.argmax(spl[start:f]))
                out.append((start, f - start, int(peak_bin[pk]),
                            float(spl[pk])))
            start = None
        if start is None and f < len(spl) and s >= threshold_db:
            start = f
    return out


def impulsive(x: torch.Tensor, rows: list[tuple], p: R.Params,
              precision: str = "f64") -> np.ndarray:
    """Each event's pile-driving metrics over its samples [onset * hop,
    (onset + frames - 1) * hop + window) of the record: SEL (dB re 1
    uPa^2 s), zero-to-peak level (dB), kurtosis (m4 / m2^2) and rise
    time (s, from the span's first sample to its largest |x|)."""
    if not rows:
        return np.zeros((0, 4))
    dt = R._dtype(precision)
    x = x.to(dt)
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    span = torch.stack([(idx >= on * p.hop)
                        & (idx < min((on + d - 1) * p.hop + p.window_size,
                                     n)) for on, d, _, _ in rows])
    x2 = x * x
    pows = torch.stack([torch.ones_like(x), x, x2, x2 * x, x2 * x2])
    s0, s1, s2, s3, s4 = R._matmul(span.to(dt), pows.T, precision).T
    mean = s1 / s0
    m2 = s2 / s0 - mean * mean
    m4 = s4 / s0 - 4 * mean * s3 / s0 + 6 * mean * mean * s2 / s0 \
        - 3 * mean ** 4
    x2m = torch.where(span, x2, torch.zeros_like(x2))
    first = torch.tensor([on * p.hop for on, _, _, _ in rows],
                         device=x.device)
    rise = (torch.argmax(x2m, dim=-1) - first).to(dt) / p.fs
    out = torch.stack([R.db(s2 / p.fs), R.db(x2m.amax(dim=-1)),
                       m4 / m2 ** 2, rise], dim=-1)
    return out.double().cpu().numpy()
