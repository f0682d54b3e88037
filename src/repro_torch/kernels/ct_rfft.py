"""K2: radix-(n1 x n2) Cooley-Tukey power spectrum for large nfft.

For paper set 2 (nfft = window = 4096, no overlap) a direct DFT costs
4*N*(N/2+1) ~ 33.6 MFLOP a frame; the split 4096 = 64*64 into two small
dense products and a twiddle costs ~2.2 MFLOP.  Derivation (n = n2*j1 +
j2, k = k1 + n1*k2):

    A[j1, j2]   = (w * x)[n2*j1 + j2]
    Y[k1, j2]   = sum_j1 A[j1, j2] W_n1^(j1 k1)       stage 1
    Z[k1, j2]   = Y[k1, j2] * W_N^(k1 j2)             twiddle
    X[k1+n1*k2] = sum_j2 Z[k1, j2] W_n2^(j2 k2)       stage 2, k2 <= n2/2

Replaces the TPU kernel ``src/repro/kernels/ct_rfft.py:122``
(``ct_frame_psd``); the CUDA source (``csrc/ct_rfft.cu``) says what
bounds it on the card and how its design answers.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.spectra import np_onesided_weights, periodogram_scale
from repro_torch.core.windows import np_window
from . import _build
from .common import LaunchCounter, check_cuda, decode_scales

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


@functools.lru_cache(maxsize=16)
def _device_constants(p, n1: int, device: str):
    """The kernel's constants on the device: the window flat and
    zero-padded to nfft, the twiddles transposed to (n2, n1)."""
    wmat, c1, s1, tr, ti, c2, s2, scale = _constants(p, n1, p.nfft // n1)
    arrays = (wmat.reshape(-1), c1, s1, tr.T, ti.T, c2, s2, scale)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in arrays)


def ct_frame_psd(frames: torch.Tensor, p, n1: int | None = None,
                 scales: torch.Tensor | None = None) -> torch.Tensor:
    """One-sided PSD of framed data, (n_frames, window_size) ->
    (n_frames, n_bins).  Accepts raw int16 PCM frames (``scales``:
    per-frame decode scales, (n_frames,); None = plain full-scale
    decode).  The frame rows may be a strided view (``unfold``): only
    the sample axis must be contiguous."""
    if frames.device.type == "cpu":
        return ct_frame_psd_plain(frames, p, n1, scales)
    check_cuda(frames, "frames", (torch.float32, torch.int16), 2)
    nfft = p.nfft
    n1 = n1 or default_n1(nfft)
    if nfft % 256 or 256 % n1 or nfft % n1 or (nfft // 256 == 1 and n1 > 128):
        raise ValueError(f"the CT kernel takes nfft a multiple of 256 and n1 "
                         f"dividing 256, got nfft={nfft}, n1={n1}")
    if frames.shape[1] != p.window_size:
        raise ValueError(f"frames have {frames.shape[1]} samples, params "
                         f"say window_size={p.window_size}")
    if frames.stride(1) != 1:
        frames = frames.contiguous()
    n_frames = frames.shape[0]
    dev = frames.device
    consts = _device_constants(p, n1, str(dev))
    ptrs = (ctypes.c_void_p * 8)(*(c.data_ptr() for c in consts))
    out = torch.empty((n_frames, p.n_bins), dtype=torch.float32, device=dev)
    tail = (out.data_ptr(), n_frames, p.window_size, nfft, n1, p.n_bins)
    tail_types = (_build.P, _build.I, _build.I, _build.I, _build.I,
                  _build.I, _build.P)
    arr = ctypes.POINTER(ctypes.c_void_p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if frames.dtype == torch.int16:
            sq = decode_scales(scales, n_frames, dev)
            fn = _build.function("depam_ct_frame_psd_i16", _build.P, _build.L,
                                 _build.P, arr, *tail_types)
            err = fn(frames.data_ptr(), frames.stride(0), sq.data_ptr(),
                     ptrs, *tail, stream)
        else:
            fn = _build.function("depam_ct_frame_psd_f32", _build.P, _build.L,
                                 arr, *tail_types)
            err = fn(frames.data_ptr(), frames.stride(0), ptrs, *tail, stream)
    _build.check(err, "ct_frame_psd")
    LAUNCHES.hit()
    return out
