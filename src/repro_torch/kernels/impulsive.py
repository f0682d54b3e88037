"""K7: per-event impulsive metrics over each event's own samples.

From a step's waveforms (float32, or raw int16 PCM with the per-record
decode scales) and K6's count-prefixed events (``counts (B,) int32``,
``rows (B, capacity, 4) float32`` = ``(onset_frame, n_frames, ...)``),
the pypam pile-driving metrics of each kept event: ``(B, capacity, 4)``
float32 rows of (SEL dB re 1 uPa^2 s, zero-to-peak level dB, kurtosis
m4/m2^2, rise time s), zeros past ``min(count, capacity)``.  An event's
samples are ``[onset*hop, (onset+dur-1)*hop + window_size)`` clipped to
the record.

K7 replaces no TPU kernel: the reference computes these metrics in plain
``jnp`` (``src/repro/api/features.py:614``), as einsums over a
``(B, capacity, record_size)`` span mask.  The plain version here keeps
that arithmetic; on the card it read the whole record once per capacity
slot and was the largest block of the detection step's device time,
memory and host dispatch, so the CUDA kernel (``csrc/impulsive.cu``)
runs one block per (record, slot) over that event's samples alone; the
source says what bounds it and how the design answers.  The kernel's
max, first argmax, peak and rise equal the plain version's bit for bit;
its float32 sums run in another order than the plain version's matrix
products, so SEL and kurtosis agree to a tolerance (``SEL_TOL_DB``,
``KURTOSIS_RTOL``).  Both payloads reach the sums with the same float32
samples and the kernel's order does not depend on the payload, so int16
and float32 give the same bits.  The wrapper launches from a launch
plan built once per configuration (the kernel needs no per-device
setup).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import spectra
from . import _build
from .common import LaunchCounter, check_cuda, decode_scales, dequantize, \
    launch

N_COLS = 4          # sel, peak, kurtosis, rise_time

LAUNCHES = LaunchCounter("impulsive_metrics")

# What the kernel is held to against its plain version: SEL within
# SEL_TOL_DB dB, kurtosis within KURTOSIS_RTOL relative (the float32
# moment sums run in another order); peak and rise bit for bit.
SEL_TOL_DB = 1e-4
KURTOSIS_RTOL = 1e-4


def impulsive_metrics_plain(x: torch.Tensor, counts: torch.Tensor,
                            rows: torch.Tensor, p,
                            scales: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The plain PyTorch version, the reference's arithmetic: moment
    sums as ``einsum`` products over a (batch, capacity, record_size)
    span mask, the peak a ``max`` / ``argmax`` over the masked x^2.
    Kurtosis uses the central-moment identities over raw power sums
    (events are zero-mean-ish pressure, so the cancellation is mild)."""
    if x.dtype == torch.int16:
        x = dequantize(x, scales)
    n = x.shape[-1]
    k = rows.shape[1]
    dev = x.device
    onset = rows[..., 0].to(torch.int32)              # (B, K) frames
    dur = rows[..., 1].to(torch.int32)
    valid = torch.arange(k, dtype=torch.int32, device=dev)[None, :] \
        < torch.clamp(counts, max=k)[:, None]
    s0 = onset * p.hop                                # first sample
    s1 = torch.clamp((onset + dur - 1) * p.hop + p.window_size, max=n)
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, None, :]
    span = ((idx >= s0[..., None]) & (idx < s1[..., None])
            & valid[..., None])                       # (B, K, N) bool
    spanf = span.to(torch.float32)
    x2 = x * x
    pows = (x, x2, x2 * x, x2 * x2)
    ns = torch.einsum("bkn->bk", spanf)
    s_1, s_2, s_3, s_4 = (torch.einsum("bn,bkn->bk", v, spanf)
                          for v in pows)
    nz = torch.clamp(ns, min=1.0)
    # a fill, not a copy from the host; a tensor divisor, so the
    # division is IEEE's and not a multiply by its reciprocal
    fs = torch.full((), float(np.float32(p.fs)), dtype=torch.float32,
                    device=dev)
    sel = spectra.db(s_2 / fs, p)                     # dB re 1 uPa^2 s
    x2m = torch.where(span, x2[:, None, :], 0.0)
    peak = spectra.db(torch.amax(x2m, dim=-1), p)     # zero-to-peak
    mean = s_1 / nz
    m2 = s_2 / nz - mean * mean
    m4 = (s_4 / nz - 4.0 * mean * (s_3 / nz)
          + 6.0 * (mean * mean) * (s_2 / nz)
          - 3.0 * (mean * mean) * (mean * mean))
    kurt = m4 / torch.clamp(m2 * m2, min=1e-30)
    rise = (torch.argmax(x2m, dim=-1).to(torch.float32)
            - s0.to(torch.float32)) / fs
    vals = torch.stack([sel, peak, kurt, rise], dim=-1)
    return torch.where(valid[..., None], vals, 0.0)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a K7 launch needs that depends only on the configuration:
    the entry point and its trailing scalars."""
    fn: object
    tail: tuple         # (hop, window, capacity, fs, gain)


@functools.lru_cache(maxsize=16)
def _plan(hop: int, window_size: int, capacity: int, fs: float,
          gain_db: float) -> _Plan:
    fn = _build.function("depam_impulsive_metrics", _build.P, _build.I,
                         _build.P, _build.P, _build.P, _build.P, _build.I,
                         _build.I, _build.I, _build.I, _build.I, _build.F,
                         _build.F, _build.P)
    # fs and the gain cross as float32, as the plain version's operands
    return _Plan(fn=fn, tail=(int(hop), int(window_size), int(capacity),
                              float(np.float32(fs)),
                              float(np.float32(gain_db))))


def check_inputs(x, counts, rows, scales, p) -> None:
    """Shapes, dtypes and devices, the same for both versions."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, N), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"x must be float32 or int16 PCM, got {x.dtype}")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32, got {rows.dtype}")
    b = x.shape[0]
    want = (b, p.event_capacity, N_COLS)
    if tuple(counts.shape) != (b,) or tuple(rows.shape) != want:
        raise ValueError(f"counts and rows must be ({b},) and {want}, got "
                         f"{tuple(counts.shape)} and {tuple(rows.shape)}")
    if scales is not None:
        if x.dtype != torch.int16:
            raise ValueError("scales go with int16 PCM only")
        if scales.dtype != torch.float32 or tuple(scales.shape) != (b,):
            raise ValueError(f"scales must be ({b},) float32, got "
                             f"{tuple(scales.shape)} {scales.dtype}")
    for name, t in (("counts", counts), ("rows", rows), ("scales", scales)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def impulsive_metrics(x: torch.Tensor, counts: torch.Tensor,
                      rows: torch.Tensor, p,
                      scales: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) float32 waveforms, or int16 PCM + ``scales`` (B,) (None:
    the plain full-scale decode), and K6's ``counts`` / ``rows`` ->
    ``(B, event_capacity, 4)`` float32 impulsive rows."""
    check_inputs(x, counts, rows, scales, p)
    if x.device.type == "cpu":
        return impulsive_metrics_plain(x, counts, rows, p, scales)
    check_cuda(x, "x", (torch.float32, torch.int16), 2)
    quantized = x.dtype == torch.int16
    n_rec, n_samples = x.shape
    dev = x.device
    x = x.contiguous()
    counts = counts.contiguous()
    rows = rows.contiguous()
    sc = decode_scales(scales, n_rec, dev) if quantized else None
    plan = _plan(p.hop, p.window_size, p.event_capacity, p.fs, p.gain_db)
    out = torch.empty((n_rec, p.event_capacity, N_COLS),
                      dtype=torch.float32, device=dev)
    err = launch(dev, plan.fn, x.data_ptr(), int(quantized),
                 None if sc is None else sc.data_ptr(), counts.data_ptr(),
                 rows.data_ptr(), out.data_ptr(), n_rec, n_samples,
                 *plan.tail)
    _build.check(err, "impulsive_metrics")
    LAUNCHES.hit()
    return out
