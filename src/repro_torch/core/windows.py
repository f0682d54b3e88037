"""Analysis windows.

Matches scipy.signal.get_window(..., fftbins=True) (periodic windows),
which is what scipy.signal.welch uses.  ``np_window`` is the float64
ground truth the kernels fold into their DFT constants on the host;
``make_window`` is the tensor view of the same values on a device.
"""
from __future__ import annotations

import numpy as np
import torch


def np_window(kind: str, n: int) -> np.ndarray:
    if kind == "rect":
        return np.ones(n, dtype=np.float64)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / n)
    raise ValueError(f"unknown window kind: {kind}")


def make_window(kind: str, n: int, dtype=torch.float32,
                device: str | torch.device = "cpu") -> torch.Tensor:
    return torch.as_tensor(np_window(kind, n), dtype=dtype, device=device)


def window_power(kind: str, n: int) -> float:
    """sum(w**2), used for the density PSD scale 1/(fs*sum(w^2))."""
    w = np_window(kind, n)
    return float(np.sum(w * w))
