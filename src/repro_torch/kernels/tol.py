"""K4: third-octave levels, banded PSD integration + dB conversion.

TOL = 10*log10(max((psd @ M) * df, 1e-30)) + gain, with M the
fractional band-membership matrix from ``core.tol``.  Replaces the TPU
kernel ``src/repro/kernels/tol.py:29``.  The CUDA kernel
(``csrc/tol.cu``) spreads the product over a block per (band, group of
8 records), each thread a strided set of bins with one accumulator per
record, then sums each record's partials by a fixed tree; the source
says what bounds it on the card and what held the earlier design back.
The wrapper launches from a launch plan built once per configuration.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build
from .common import LaunchCounter, check_cuda, launch

LAUNCHES = LaunchCounter("tol_levels")


def tol_levels_plain(psd: torch.Tensor, band_matrix: torch.Tensor,
                     p) -> torch.Tensor:
    """The plain PyTorch version: one f32 product, scale, log."""
    power = (psd.to(torch.float32) @ band_matrix.to(torch.float32)) * p.df
    return 10.0 * torch.log10(torch.clamp(power, min=1e-30)) + p.gain_db


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a K4 launch needs that depends only on the configuration:
    the entry point and its trailing scalars.  Nothing in it depends on
    the device: K4 has no constants, one route, and no shared-memory
    limit to raise."""
    fn: object
    tail: tuple                 # (df, gain_db)


@functools.lru_cache(maxsize=16)
def _plan(p) -> _Plan:
    fn = _build.function("depam_tol_levels", _build.P, _build.P, _build.P,
                         _build.I, _build.I, _build.I, _build.F, _build.F,
                         _build.P)
    return _Plan(fn=fn, tail=(float(p.df), float(p.gain_db)))


def tol_levels(psd: torch.Tensor, band_matrix: torch.Tensor,
               p) -> torch.Tensor:
    """(n_records, n_bins) x (n_bins, n_bands) -> (n_records, n_bands) dB."""
    if psd.device.type == "cpu":
        return tol_levels_plain(psd, band_matrix, p)
    check_cuda(psd, "psd", (torch.float32,), 2)
    check_cuda(band_matrix, "band_matrix", (torch.float32,), 2)
    n_rec, n_bins = psd.shape
    if band_matrix.shape[0] != n_bins:
        raise ValueError(f"band_matrix has {band_matrix.shape[0]} rows for "
                         f"{n_bins} PSD bins")
    psd = psd.contiguous()
    band_matrix = band_matrix.contiguous()
    n_bands = band_matrix.shape[1]
    dev = psd.device
    plan = _plan(p)
    out = torch.empty((n_rec, n_bands), dtype=torch.float32, device=dev)
    err = launch(dev, plan.fn, psd.data_ptr(), band_matrix.data_ptr(),
                 out.data_ptr(), n_rec, n_bins, n_bands, *plan.tail)
    _build.check(err, "tol_levels")
    LAUNCHES.hit()
    return out
