"""Oracles with arithmetic of their own for the DEPAM kernels: the
per-frame PSD of pre-extracted frames (K2) and a frame-by-frame event
detector (K6).  The other kernels' tests hold them against
``core.spectra`` (scipy-welch compatible) directly."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spectra
from repro_torch.core.windows import make_window


def ct_frame_psd(frames: torch.Tensor, p) -> torch.Tensor:
    """Oracle for the CT kernel: PSD of pre-framed, pre-extracted frames."""
    w = make_window(p.window, p.window_size, frames.dtype, frames.device)
    spec = torch.fft.rfft(frames * w, n=p.nfft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    scale = torch.tensor(spectra.periodogram_scale(p), dtype=frames.dtype,
                         device=frames.device)
    return power * scale * spectra.onesided_weights(p.nfft, frames.dtype,
                                                    frames.device)


def detect_events(frame_spl: torch.Tensor, frame_peak_bin: torch.Tensor,
                  p) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame-by-frame re-implementation of the Schmitt trigger, record
    by record in numpy float32 (the close level is f32(threshold) -
    f32(hysteresis); peaks use strict >).  Knobs come off ``p``."""
    spl = frame_spl.detach().cpu().numpy().astype(np.float32)
    pk_bin = frame_peak_bin.detach().cpu().numpy().astype(np.int32)
    thr = np.float32(p.event_threshold_db)
    lo = np.float32(p.event_threshold_db) - np.float32(p.event_hysteresis_db)
    cap, min_len = p.event_capacity, p.event_min_len
    n_rec, n_frames = spl.shape
    counts = np.zeros(n_rec, np.int32)
    rows = np.zeros((n_rec, cap, 4), np.float32)
    for i in range(n_rec):
        evs, in_ev, start, pk_db, pk = [], False, 0, None, 0
        for f in range(n_frames):
            s = spl[i, f]
            if in_ev and s < lo:
                if f - start >= min_len:
                    evs.append((start, f - start, pk, pk_db))
                in_ev = False
            if in_ev and s > pk_db:
                pk_db, pk = s, pk_bin[i, f]
            if not in_ev and s >= thr:
                in_ev, start, pk_db, pk = True, f, s, pk_bin[i, f]
        if in_ev and n_frames - start >= min_len:
            evs.append((start, n_frames - start, pk, pk_db))
        counts[i] = len(evs)
        for j, ev in enumerate(evs[:cap]):
            rows[i, j] = ev
    return torch.as_tensor(counts), torch.as_tensor(rows)
