"""K1 and K5: the fused PSD kernels of paper set 1.

For the small analysis windows of paper set 1 (nfft = window = 256,
hop 128) the whole chain

    frames -> window -> rfft -> |.|^2 -> density scale [-> frame mean]

runs in one kernel that reads the signal once (``csrc/framepsd.cu``):

  * K1 ``welch_psd`` — the per-record Welch PSD; the per-frame spectra
    never reach device memory.  Replaces the TPU kernel
    ``src/repro/kernels/framepsd.py:239``.
  * K5 ``frame_psd`` — the per-frame PSD (the spectrogram behind
    ``percentiles``, ``spd`` and detection), each frame's row stored
    from the FFT buffer in one coalesced run per warp.  Replaces the TPU
    kernel ``src/repro/kernels/framepsd.py:130``.

Both take one route by shape: a radix-8/4 FFT per frame
(``csrc/fft.cuh``, plan in ``fftplan.py``) for a power-of-two nfft from
128 to 512 with window <= nfft, the window-folded direct DFT for any
other nfft.  Each wrapper launches from a launch plan built once per
configuration and device.

The plain versions compute the reference's folded direct DFT.  The CUDA
source says what bounds the kernels on the card and how the design
answers.  Raw int16 PCM is accepted (dtype drives the dispatch) with a
per-record decode scale: the kernel converts and scales the samples as
it stages them, before any product — the host decode's exact rounding,
so the int16 and float32 calls give the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.spectra import (frame_signal, np_onesided_weights,
                                      periodogram_scale)
from repro_torch.core.windows import np_window
from . import _build, fftplan
from .common import (LaunchCounter, check_cuda, decode_scales, dequantize,
                     dft_matrices, launch, pointers)

LAUNCHES = LaunchCounter("welch_psd")
LAUNCHES_FRAME = LaunchCounter("frame_psd")


def _fold_matrices(p, dtype=np.float32):
    """Split window-folded DFT matrices by hop phase: (m, hop, n_bins)."""
    w = np_window(p.window, p.window_size)
    c, s = dft_matrices(p.window_size, p.nfft, w, dtype=np.float64)
    m = p.window_size // p.hop
    c = c.reshape(m, p.hop, p.n_bins).astype(dtype)
    s = s.reshape(m, p.hop, p.n_bins).astype(dtype)
    return c, s


def _bin_scale(p, extra: float = 1.0, dtype=np.float32) -> np.ndarray:
    """Combined one-sided weight * density scale (* extra), (1, n_bins)."""
    w = np_onesided_weights(p.nfft)
    return (w * periodogram_scale(p) * extra).astype(dtype)[None, :]


def _frame_power(x: torch.Tensor, p,
                 scales: torch.Tensor | None) -> torch.Tensor:
    """re^2 + im^2 of every frame's window-length dot with the folded
    DFT matrices, unscaled: the arithmetic both plain versions share."""
    xf = dequantize(x, scales) if x.dtype == torch.int16 \
        else x.to(torch.float32)
    c, s = _fold_matrices(p)
    c = torch.as_tensor(c.reshape(p.window_size, p.n_bins), device=xf.device)
    s = torch.as_tensor(s.reshape(p.window_size, p.n_bins), device=xf.device)
    frames = frame_signal(xf, p.window_size, p.hop)
    re = frames @ c
    im = frames @ s
    return re * re + im * im


def welch_psd_plain(records: torch.Tensor, p,
                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K1: the frames' folded-DFT power,
    summed over frames, one scale."""
    power = _frame_power(records, p, scales)
    fpr = power.shape[-2]
    return power.sum(dim=-2) * torch.as_tensor(_bin_scale(p, 1.0 / fpr)[0],
                                               device=power.device)


def _route_constants(p, fpr: int, fft: bool, device: torch.device):
    """The constants K1 and K5 take, in the order of their pointer
    array — C, S (direct route: the folded DFT matrices zero-padded to
    whole warps of bins), bin scale (with K1's 1/fpr folded in; K5
    passes fpr=1), window, twiddles, split factors (FFT route) — and
    the FFT plan's (radices, passes, twiddles), zeros on the direct
    route."""
    scale = _bin_scale(p, extra=1.0 / fpr)[0]
    if fft:
        fp = fftplan.plan(p.nfft)
        w = np_window(p.window, p.window_size).astype(np.float32)
        arrays = (None, None, scale, w, fp.twiddles, fp.split)
        mid = (fp.packed, len(fp.radices), len(fp.twiddles))
    else:
        c, s = _fold_matrices(p)
        pad = ((0, 0), (0, -(-p.n_bins // 32) * 32 - p.n_bins))
        arrays = (np.pad(c.reshape(p.window_size, p.n_bins), pad),
                  np.pad(s.reshape(p.window_size, p.n_bins), pad), scale,
                  None, None, None)
        mid = (0, 0, 0)
    return tuple(None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), device=device) for a in arrays), mid


# The C entry points' arguments after the payload (and, for int16, the
# decode scales): pointer array, radices, passes, twiddles, [partial,]
# out, records, frames, window, hop, nfft, bins, stream.
def _entry_points(name: str, scratch: bool):
    tail = (_build.P, _build.U, _build.I, _build.I) \
        + (_build.P,) * (2 if scratch else 1) + (_build.I,) * 6 + (_build.P,)
    return (_build.function(f"{name}_f32", _build.P, _build.L, _build.L,
                            *tail),
            _build.function(f"{name}_i16", _build.P, _build.L, _build.L,
                            _build.P, *tail))


@dataclasses.dataclass(frozen=True)
class _WelchPlan:
    """What a K1 launch needs that depends only on the configuration,
    the record length and the device: built once (the C side picks the
    route by shape and raises the kernels' shared-memory limit), then
    each call allocates its scratch and output and passes pointers."""
    consts: tuple               # device tensors the pointers point into
    mid: tuple                  # (pointer array, radices, passes, twiddles)
    tail: tuple                 # (frames, window, hop, nfft, n_bins)
    n_chunks: int               # K1 blocks per record
    cols: int                   # columns of a block's partial
    f32: object
    i16: object


@functools.lru_cache(maxsize=16)
def _welch_plan(p, n: int, device: torch.device) -> _WelchPlan:
    fpr = (n - p.window_size) // p.hop + 1
    route, block, cols = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    fn = _build.function("depam_welch_psd_plan", _build.I, _build.I,
                         _build.I, _build.I, ip, ip, ip)
    with torch.cuda.device(device):
        err = fn(p.nfft, p.window_size, p.hop, p.n_bins, ctypes.byref(route),
                 ctypes.byref(block), ctypes.byref(cols))
    _build.check(err, "welch_psd plan")
    consts, mid = _route_constants(p, fpr, bool(route.value), device)
    f32, i16 = _entry_points("depam_welch_psd", scratch=True)
    return _WelchPlan(
        consts=consts, mid=(pointers(consts),) + mid,
        tail=(fpr, p.window_size, p.hop, p.nfft, p.n_bins),
        n_chunks=-(-fpr // block.value), cols=cols.value, f32=f32, i16=i16)


@dataclasses.dataclass(frozen=True)
class _FramePlan:
    """What a K5 launch needs that depends only on the configuration
    and the device: built once (the C side picks the route by shape and
    raises the kernel's shared-memory limit), then each call allocates
    its output and passes pointers."""
    route: str                  # "fft" or "direct"
    consts: tuple               # device tensors the pointers point into
    mid: tuple                  # (pointer array, radices, passes, twiddles)
    tail: tuple                 # (window, hop, nfft, n_bins)
    f32: object
    i16: object


@functools.lru_cache(maxsize=16)
def _frame_plan(p, device: torch.device) -> _FramePlan:
    route = ctypes.c_int()
    fn = _build.function("depam_frame_psd_plan", _build.I, _build.I,
                         _build.I, _build.I, ctypes.POINTER(ctypes.c_int))
    with torch.cuda.device(device):
        err = fn(p.nfft, p.window_size, p.hop, p.n_bins, ctypes.byref(route))
    _build.check(err, "frame_psd plan")
    consts, mid = _route_constants(p, 1, bool(route.value), device)
    f32, i16 = _entry_points("depam_frame_psd", scratch=False)
    return _FramePlan(
        route="fft" if route.value else "direct", consts=consts,
        mid=(pointers(consts),) + mid,
        tail=(p.window_size, p.hop, p.nfft, p.n_bins), f32=f32, i16=i16)


def welch_psd(records: torch.Tensor, p,
              scales: torch.Tensor | None = None) -> torch.Tensor:
    """Per-record Welch PSD, (n_records, record_size) -> (n_records,
    n_bins).  ``records`` may be raw int16 PCM (``scales``: per-record
    decode scales, (n_records,); None = plain full-scale decode)."""
    if records.device.type == "cpu":
        return welch_psd_plain(records, p, scales)
    check_cuda(records, "records", (torch.float32, torch.int16), 2)
    if p.window_size % p.hop:
        raise ValueError("the fused Welch kernel requires hop | window_size")
    if p.n_bins > 9 * 32:
        raise ValueError(f"the fused Welch kernel takes at most 288 bins "
                         f"(nfft <= 574), got {p.n_bins}")
    if records.stride(1) != 1:
        records = records.contiguous()
    n_rec, n = records.shape
    if n < p.window_size:
        raise ValueError(f"records of {n} samples hold no frame of "
                         f"{p.window_size}")
    dev = records.device
    plan = _welch_plan(p, n, dev)
    partial = torch.empty((n_rec, plan.n_chunks, plan.cols),
                          dtype=torch.float32, device=dev)
    out = torch.empty((n_rec, p.n_bins), dtype=torch.float32, device=dev)
    if records.dtype == torch.int16:
        sq = decode_scales(scales, n_rec, dev)
        err = launch(dev, plan.i16, records.data_ptr(), records.stride(0), n,
                     sq.data_ptr(), *plan.mid, partial.data_ptr(),
                     out.data_ptr(), n_rec, *plan.tail)
    else:
        err = launch(dev, plan.f32, records.data_ptr(), records.stride(0), n,
                     *plan.mid, partial.data_ptr(), out.data_ptr(), n_rec,
                     *plan.tail)
    _build.check(err, "welch_psd")
    LAUNCHES.hit()
    return out


def frame_psd_plain(x: torch.Tensor, p,
                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K5: each frame's folded-DFT power
    times the bin scale."""
    power = _frame_power(x, p, scales)
    return power * torch.as_tensor(_bin_scale(p)[0], device=power.device)


def frame_psd(x: torch.Tensor, p,
              scales: torch.Tensor | None = None) -> torch.Tensor:
    """Per-frame one-sided PSD: (n_samples,) -> (n_frames, n_bins) or
    (n_records, record_size) -> (n_records, frames_per_record, n_bins).
    ``x`` may be raw int16 PCM (``scales``: one decode scale per record,
    a scalar for 1-D input; None = plain full-scale decode)."""
    if x.device.type == "cpu":
        return frame_psd_plain(x, p, scales)
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be 1-D or 2-D, got {tuple(x.shape)}")
    check_cuda(x, "x", (torch.float32, torch.int16), x.dim())
    if p.window_size % p.hop:
        raise ValueError("the fused frame-PSD kernel requires "
                         "hop | window_size")
    if p.n_bins > 9 * 32:
        raise ValueError(f"the fused frame-PSD kernel takes at most 288 "
                         f"bins (nfft <= 574), got {p.n_bins}")
    records = x if x.dim() == 2 else x[None]
    if records.stride(1) != 1:
        records = records.contiguous()
    n_rec, n = records.shape
    fpr = (n - p.window_size) // p.hop + 1
    if fpr < 1:
        raise ValueError(f"records of {n} samples hold no frame of "
                         f"{p.window_size}")
    dev = records.device
    plan = _frame_plan(p, dev)
    out = torch.empty((n_rec, fpr, p.n_bins), dtype=torch.float32,
                      device=dev)
    if records.dtype == torch.int16:
        if scales is not None:
            scales = torch.as_tensor(scales, dtype=torch.float32,
                                     device=dev).reshape(-1)
        sq = decode_scales(scales, n_rec, dev)
        err = launch(dev, plan.i16, records.data_ptr(), records.stride(0), n,
                     sq.data_ptr(), *plan.mid, out.data_ptr(), n_rec, fpr,
                     *plan.tail)
    else:
        err = launch(dev, plan.f32, records.data_ptr(), records.stride(0), n,
                     *plan.mid, out.data_ptr(), n_rec, fpr, *plan.tail)
    _build.check(err, "frame_psd")
    LAUNCHES_FRAME.hit()
    return out if x.dim() == 2 else out[0]
