"""K2: per-frame one-sided power spectrum for large nfft.

The reference (and this module's plain version) splits nfft = n1*n2
into two small dense products and a twiddle, the TPU's shape
(n = n2*j1 + j2, k = k1 + n1*k2):

    A[j1, j2]   = (w * x)[n2*j1 + j2]
    Y[k1, j2]   = sum_j1 A[j1, j2] W_n1^(j1 k1)       stage 1
    Z[k1, j2]   = Y[k1, j2] * W_N^(k1 j2)             twiddle
    X[k1+n1*k2] = sum_j2 Z[k1, j2] W_n2^(j2 k2)       stage 2, k2 <= n2/2

The CUDA kernel (``csrc/ct_rfft.cu``) computes the same function by a
radix-8/4 FFT (``csrc/fft.cuh``, plan in ``fftplan.py``), so its result
does not depend on ``n1``; the source says what bounds it on the card
and how its design answers.  Replaces the TPU kernel
``src/repro/kernels/ct_rfft.py:122`` (``ct_frame_psd``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.spectra import np_onesided_weights, periodogram_scale
from repro_torch.core.windows import np_window
from . import _build, fftplan
from .common import LaunchCounter, check_cuda, decode_scales, launch, \
    pointers

LAUNCHES = LaunchCounter("ct_frame_psd")


def default_n1(nfft: int) -> int:
    """~sqrt(nfft), a power of two (64 at 4096)."""
    return 1 << (int(np.log2(nfft)) + 1) // 2


def _constants(p, n1: int, n2: int, dtype=np.float32):
    """(window (n1, n2), c1, s1 (n1, n1), tr, ti (n1, n2), c2, s2
    (n2, n2h), bin scale (n2h, n1)) — the reference's layout."""
    nfft = p.nfft
    assert n1 * n2 == nfft
    n2h = n2 // 2 + 1

    w = np_window(p.window, p.window_size)
    w = np.pad(w, (0, nfft - p.window_size))  # zero-padded FFT case
    wmat = w.reshape(n1, n2)

    j1 = np.arange(n1)[:, None].astype(np.float64)
    k1 = np.arange(n1)[None, :].astype(np.float64)
    ang1 = 2.0 * np.pi * j1 * k1 / n1
    c1, s1 = np.cos(ang1), -np.sin(ang1)

    kk1 = np.arange(n1)[:, None].astype(np.float64)
    nn2 = np.arange(n2)[None, :].astype(np.float64)
    angt = 2.0 * np.pi * kk1 * nn2 / nfft
    tr, ti = np.cos(angt), -np.sin(angt)

    j2 = np.arange(n2)[:, None].astype(np.float64)
    k2 = np.arange(n2h)[None, :].astype(np.float64)
    ang2 = 2.0 * np.pi * j2 * k2 / n2
    c2, s2 = np.cos(ang2), -np.sin(ang2)

    # Per-bin scale laid out as the (n2h, n1) output: bin k1 + n1*k2.
    ow = np_onesided_weights(nfft)
    scale_flat = np.zeros(n2h * n1)
    scale_flat[: nfft // 2 + 1] = ow * periodogram_scale(p)
    scale = scale_flat.reshape(n2h, n1)

    return [a.astype(dtype) for a in (wmat, c1, s1, tr, ti, c2, s2, scale)]


def _float_frames(frames: torch.Tensor, scales) -> torch.Tensor:
    if frames.dtype == torch.int16:
        s = decode_scales(scales, frames.shape[0], frames.device)
        return frames.to(torch.float32) * s[:, None]
    return frames.to(torch.float32)


def ct_frame_psd_plain(frames: torch.Tensor, p, n1: int | None = None,
                       scales: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the same two-stage chain."""
    nfft = p.nfft
    n1 = n1 or default_n1(nfft)
    n2 = nfft // n1
    x = _float_frames(frames, scales)
    if p.window_size < nfft:
        x = torch.nn.functional.pad(x, (0, nfft - p.window_size))
    wmat, c1, s1, tr, ti, c2, s2, scale = (
        torch.as_tensor(a, device=x.device) for a in _constants(p, n1, n2))
    a = x.reshape(-1, n1, n2) * wmat
    yr = torch.einsum("nk,bnm->bkm", c1, a)
    yi = torch.einsum("nk,bnm->bkm", s1, a)
    zr = yr * tr - yi * ti
    zi = yr * ti + yi * tr
    xr = zr @ c2 - zi @ s2
    xi = zr @ s2 + zi @ c2
    power = (xr * xr + xi * xi).transpose(1, 2) * scale
    return power.reshape(x.shape[0], -1)[:, : p.n_bins]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Everything a launch needs that depends only on the configuration
    and the device: built once, then each call allocates its output and
    passes pointers."""
    consts: tuple               # device tensors the pointers point into
    mid: tuple                  # (pointer array, radices, passes, twiddles)
    tail: tuple                 # (window, nfft, n_bins)
    f32: object
    i16: object


@functools.lru_cache(maxsize=16)
def _plan(p, device: torch.device) -> _Plan:
    fp = fftplan.plan(p.nfft)
    w = np_window(p.window, p.window_size).astype(np.float32)
    scale = (np_onesided_weights(p.nfft)
             * periodogram_scale(p)).astype(np.float32)
    consts = tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                   for a in (w, fp.twiddles, fp.split, scale))
    tail_types = (_build.P, _build.U, _build.I, _build.I, _build.P,
                  _build.I, _build.I, _build.I, _build.I, _build.P)
    return _Plan(
        consts=consts,
        mid=(pointers(consts), fp.packed, len(fp.radices),
             len(fp.twiddles)),
        tail=(p.window_size, p.nfft, p.n_bins),
        f32=_build.function("depam_ct_frame_psd_f32", _build.P, _build.L,
                            *tail_types),
        i16=_build.function("depam_ct_frame_psd_i16", _build.P, _build.L,
                            _build.P, *tail_types))


def ct_frame_psd(frames: torch.Tensor, p, n1: int | None = None,
                 scales: torch.Tensor | None = None) -> torch.Tensor:
    """One-sided PSD of framed data, (n_frames, window_size) ->
    (n_frames, n_bins).  Accepts raw int16 PCM frames (``scales``:
    per-frame decode scales, (n_frames,); None = plain full-scale
    decode).  The frame rows may be a strided view (``unfold``): only
    the sample axis must be contiguous.  On the card ``n1`` is checked
    as the reference checks it but does not change the result."""
    if frames.device.type == "cpu":
        return ct_frame_psd_plain(frames, p, n1, scales)
    check_cuda(frames, "frames", (torch.float32, torch.int16), 2)
    nfft = p.nfft
    n1 = n1 or default_n1(nfft)
    if nfft % 256 or 256 % n1 or nfft % n1 or (nfft // 256 == 1 and n1 > 128):
        raise ValueError(f"the CT kernel takes nfft a multiple of 256 and n1 "
                         f"dividing 256, got nfft={nfft}, n1={n1}")
    if nfft > 8192 or nfft & (nfft - 1):
        raise ValueError(f"the CT kernel takes a power-of-two nfft from 256 "
                         f"to 8192, got {nfft}")
    if frames.shape[1] != p.window_size:
        raise ValueError(f"frames have {frames.shape[1]} samples, params "
                         f"say window_size={p.window_size}")
    if frames.stride(1) != 1:
        frames = frames.contiguous()
    n_frames = frames.shape[0]
    dev = frames.device
    plan = _plan(p, dev)
    out = torch.empty((n_frames, p.n_bins), dtype=torch.float32, device=dev)
    if frames.dtype == torch.int16:
        sq = decode_scales(scales, n_frames, dev)
        err = launch(dev, plan.i16, frames.data_ptr(), frames.stride(0),
                     sq.data_ptr(), *plan.mid, out.data_ptr(), n_frames,
                     *plan.tail)
    else:
        err = launch(dev, plan.f32, frames.data_ptr(), frames.stride(0),
                     *plan.mid, out.data_ptr(), n_frames, *plan.tail)
    _build.check(err, "ct_frame_psd")
    LAUNCHES.hit()
    return out
