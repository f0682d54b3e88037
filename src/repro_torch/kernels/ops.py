"""Public entry points for the DEPAM kernels, with dispatch.

``psd_backend`` picks the kernel for a parameter set, by the reference's
rule:
  * direct   — fused frame+window+DFT (framepsd: K1 Welch, K5 per
               frame), nfft <= 512 and hop | window_size.  Paper set 1.
  * ct       — per-frame PSD (ct_rfft, K2: an FFT on the card, the
               reference's two-stage Cooley-Tukey in the plain
               version), then the frame mean (welch, K3) for Welch;
               large power-of-two nfft.  Paper set 2.
  * xla      — the plain ``core.spectra`` path (torch.fft) for anything
               else (the name is the reference's).

Every entry point takes float32 or raw int16 PCM (with the per-record
``scales`` sidecar): the kernels dequantize as they load, the plain path
dequantizes first, all bitwise-identical to feeding host-decoded float32.
``detect_events`` (K6) scans a frame-SPL trace for loud events, and
``impulsive_metrics`` (K7) reads each event's own samples for its
impulsive metrics.

This module alone picks kernel or plain: every PSD, TOL, event and
impulsive entry point takes ``kernel`` (the job's ``.kernels(...)``).
``kernel=False`` runs the plain route on any device — ``core.spectra``
for the PSDs and TOL, the kernel module's plain version for K6 and K7.
With ``kernel=True`` a CUDA tensor launches the kernel and a CPU tensor
takes each kernel module's plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core import spectra
from . import common, ct_rfft, events as events_kernel, framepsd, \
    impulsive as impulsive_kernel, tol as tol_kernel, welch as welch_kernel


def psd_backend(p) -> str:
    if p.nfft <= 512 and p.window_size % p.hop == 0:
        return "direct"
    if p.nfft >= 1024 and (p.nfft & (p.nfft - 1)) == 0:
        return "ct"
    return "xla"


def _frame_scales(scales, lead: tuple[int, ...], nf: int, device):
    """Per-record decode scales -> one per flattened frame (or None)."""
    if scales is None:
        return None
    s = torch.as_tensor(scales, dtype=torch.float32, device=device)
    return s[..., None].expand(lead + (nf,)).reshape(-1)


def frame_psd(x: torch.Tensor, p, backend: str | None = None,
              scales: torch.Tensor | None = None, *,
              kernel: bool = True) -> torch.Tensor:
    """Per-frame PSD. x: (n_samples,) or (n_records, record_size),
    float32 or raw int16 PCM (+ per-record ``scales`` sidecar);
    ``kernel=False`` takes the plain ``"xla"`` route."""
    backend = (backend or psd_backend(p)) if kernel else "xla"
    quantized = x.dtype == torch.int16
    if backend == "direct":
        return framepsd.frame_psd(x, p, scales=scales)
    if backend == "ct":
        frames = spectra.frame_signal(x, p.window_size, p.hop)
        shape = frames.shape
        sf = _frame_scales(scales, tuple(shape[:-2]), shape[-2], x.device) \
            if quantized else None
        out = ct_rfft.ct_frame_psd(frames.reshape(-1, p.window_size), p,
                                   scales=sf)
        return out.reshape(*shape[:-1], p.n_bins)
    if quantized:
        x = common.dequantize(x, scales)
    return spectra.frame_psd(x, p)


def welch_psd(records: torch.Tensor, p, backend: str | None = None,
              scales: torch.Tensor | None = None, *,
              kernel: bool = True) -> torch.Tensor:
    """Per-record Welch PSD. records: (n_records, record_size),
    float32 or raw int16 PCM (+ per-record ``scales`` sidecar);
    ``kernel=False`` takes the plain ``"xla"`` route."""
    backend = (backend or psd_backend(p)) if kernel else "xla"
    if backend == "direct":
        return framepsd.welch_psd(records, p, scales=scales)
    if backend == "ct":
        fp = frame_psd(records, p, backend="ct", scales=scales)
        return welch_kernel.welch_mean(fp)
    if records.dtype == torch.int16:
        records = common.dequantize(records, scales)
    return spectra.welch_psd(records, p)


def tol_levels(psd: torch.Tensor, band_matrix: torch.Tensor, p, *,
               kernel: bool = True) -> torch.Tensor:
    """Third-octave levels (dB) of a (n_records, n_bins) PSD;
    ``kernel=False`` runs ``core.spectra.tol_levels``."""
    fn = tol_kernel.tol_levels if kernel else spectra.tol_levels
    return fn(psd, band_matrix, p)


def detect_events(frame_spl: torch.Tensor, frame_peak_bin: torch.Tensor, p,
                  kernel: bool = True):
    """Threshold + compaction over per-frame wideband SPL (dB).

    frame_spl / frame_peak_bin: (n_records, frames_per_record) float32 /
    int32.  The knobs come off ``p`` (DepamParams).  Returns ``(counts
    (n,) int32, rows (n, event_capacity, 4) float32)`` — see
    kernels/events.py for the encoding.  ``kernel=False`` runs the plain
    version on any device; both give the same bits."""
    fn = events_kernel.detect_events if kernel \
        else events_kernel.detect_events_plain
    return fn(frame_spl, frame_peak_bin,
              threshold_db=p.event_threshold_db,
              hysteresis_db=p.event_hysteresis_db,
              min_len=p.event_min_len, capacity=p.event_capacity)


def impulsive_metrics(x: torch.Tensor, counts: torch.Tensor,
                      rows: torch.Tensor, p,
                      scales: torch.Tensor | None = None,
                      kernel: bool = True) -> torch.Tensor:
    """Per-event impulsive metrics (SEL, zero-to-peak level, kurtosis,
    rise time) over each detected event's samples.

    x: (n_records, record_size) float32, or raw int16 PCM with the
    per-record ``scales`` sidecar; counts / rows: ``detect_events``'s
    output.  Returns ``(n_records, event_capacity, 4)`` float32, zeros
    past each record's kept events — see kernels/impulsive.py.
    ``kernel=False`` runs the plain version on any device."""
    if kernel:
        return impulsive_kernel.impulsive_metrics(x, counts, rows, p,
                                                  scales=scales)
    impulsive_kernel.check_inputs(x, counts, rows, scales, p)
    return impulsive_kernel.impulsive_metrics_plain(x, counts, rows, p,
                                                    scales=scales)


def launch_counters() -> dict[str, "common.LaunchCounter"]:
    """Every kernel's launch counter, by kernel name."""
    return {c.name: c for c in (
        framepsd.LAUNCHES, ct_rfft.LAUNCHES, welch_kernel.LAUNCHES,
        tol_kernel.LAUNCHES, framepsd.LAUNCHES_FRAME,
        events_kernel.LAUNCHES, impulsive_kernel.LAUNCHES)}
