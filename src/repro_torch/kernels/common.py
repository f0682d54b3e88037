"""Shared helpers for the DEPAM CUDA kernels and their plain versions.

Every kernel module follows one pattern: a wrapper that checks its
tensors, launches the hand-written kernel for a CUDA tensor (counting
the launch), and runs the plain PyTorch version of the same function
for a CPU tensor.  A CUDA tensor never reaches the plain version
through a wrapper: it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.params import PCM_DECODE_SCALE


class LaunchCounter:
    """Plain integer count of kernel launches, one per wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def hit(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def dequantize(pcm: torch.Tensor, scales: torch.Tensor | None = None
               ) -> torch.Tensor:
    """int16 PCM -> float32 waveform, bitwise-matching the host decode.

    One exact int16->float32 convert plus ONE float32 multiply by the
    per-record decode scale (``PCM_DECODE_SCALE * gain``, fused on the
    host; ``None`` = plain full-scale decode) — the same single rounding
    the host float path performs, so the two transports agree bitwise.
    """
    w = pcm.to(torch.float32)
    if scales is None:
        return w * torch.tensor(PCM_DECODE_SCALE, dtype=torch.float32,
                                device=pcm.device)
    s = torch.as_tensor(scales, dtype=torch.float32, device=pcm.device)
    return w * s[..., None]


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dft_matrices(n_in: int, nfft: int, window: np.ndarray,
                 dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices (C, S), each (n_in, n_bins), with
    C[j, k] = window[j] cos(2 pi j k / nfft) and
    S[j, k] = -window[j] sin(2 pi j k / nfft), so that for a real frame
    f: rfft(window * f, nfft) = f @ C + 1j * (f @ S)."""
    n_bins = nfft // 2 + 1
    j = np.arange(n_in)[:, None].astype(np.float64)
    k = np.arange(n_bins)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * j * k / nfft
    c = (window[:, None] * np.cos(ang)).astype(dtype)
    s = (-window[:, None] * np.sin(ang)).astype(dtype)
    return c, s


def decode_scales(scales, n: int, device: torch.device) -> torch.Tensor:
    """Per-record (or per-frame) float32 decode scales, ``(n,)`` on
    ``device``; None means the plain full-scale decode."""
    if scales is None:
        return torch.full((n,), float(PCM_DECODE_SCALE), dtype=torch.float32,
                          device=device)
    s = torch.as_tensor(scales, dtype=torch.float32, device=device)
    if s.shape != (n,):
        raise ValueError(f"expected {n} decode scales, got shape "
                         f"{tuple(s.shape)}")
    return s.contiguous()


def check_cuda(t: torch.Tensor, name: str, dtypes: tuple, ndim: int) -> None:
    """The checks every launch wrapper makes before it passes a pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (NULL for None), built
    once per launch plan: the entry points take their constants so."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``dev`` current and ``stream`` its
    current stream: a kernel launches on the current device, so the
    device is switched only when it is not already the current one."""
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return launch(dev, fn, *args)
    return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
