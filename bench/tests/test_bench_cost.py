"""The benchmark's frozen cost model (``bench/harness/cost.py``) held to
the program's own (``src/repro_torch/kernels/roofline.py``) at the
shapes ``chip_smoke.py`` times each kernel at: 8 records of a paper set.

Where they differ, they differ by design, and the tests pin the
difference exactly:

  * paper set 2's Welch PSD: the program costs its route, K2 (frames in,
    per-frame PSDs out) plus K3 (per-frame PSDs in, the mean out), so the
    per-frame spectra between the two count twice, once written and once
    read, and K3's frame sum is counted again although ``psd_flops``
    already holds it.  The frozen model costs the function
    ``ops.welch_psd`` by its own input and output on every route, so that
    a route that fuses the two reads closer to its bound, never above it;
  * raw int16 payloads: the program's model counts 4-byte samples; the
    frozen model counts what the call receives, 2 bytes a sample and a
    4-byte decode scale a record.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

from harness import cost  # noqa: E402
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2  # noqa: E402
from repro_torch.core.tol import band_matrix  # noqa: E402
from repro_torch.distributed import roofline  # noqa: E402
from repro_torch.kernels import roofline as program  # noqa: E402

R = 8      # chip_smoke.py phase 2: records a step


def _args(p):
    return p.nfft, p.window_size, p.hop


def test_peaks_are_the_programs():
    assert cost.HBM_BYTES_PER_S == roofline.HBM_BW
    assert cost.F32_FLOPS_PER_S == roofline.PEAK_FLOPS[torch.float32]


def test_psd_flops_is_the_programs():
    for n in (128, 256, 4096):
        assert cost.psd_flops(n, n // 2 + 1) \
            == program.psd_flops(n, n // 2 + 1)


def test_welch_psd_set1_equals_k1():
    p = PARAM_SET_1
    got = cost.welch_psd(R, p.record_size, "float32", *_args(p))
    want = program.welch_psd_cost(R, p.record_size, p)
    assert (got.bytes, got.flops) == (want.hbm_bytes, want.flops)
    assert got.bound == want.bound == "bytes"
    assert got.bound_s == want.bound_s


def test_welch_psd_set2_is_k2_plus_k3_without_the_intermediate():
    p = PARAM_SET_2
    frames = p.record_size // p.hop               # 80 a record
    got = cost.welch_psd(R, p.record_size, "float32", *_args(p))
    k2 = program.ct_cost(R * frames, p)
    k3 = program.welch_mean_cost(R, frames, p.n_bins)
    inter = 4 * R * frames * p.n_bins             # K2's output, K3's input
    assert got.bytes == k2.hbm_bytes + k3.hbm_bytes - 2 * inter
    assert got.flops == k2.flops == k2.flops + k3.flops - R * frames * p.n_bins
    assert got.bound_s < k2.bound_s + k3.bound_s


@pytest.mark.parametrize("p", [PARAM_SET_1, PARAM_SET_2], ids=["set1",
                                                             "set2"])
def test_int16_payload_counts_two_bytes_and_a_scale(p):
    f32 = cost.welch_psd(R, p.record_size, "float32", *_args(p))
    i16 = cost.welch_psd(R, p.record_size, "int16", *_args(p))
    assert f32.bytes - i16.bytes == 2 * R * p.record_size - 4 * R
    assert f32.flops == i16.flops


@pytest.mark.parametrize("p", [PARAM_SET_1, PARAM_SET_2], ids=["set1",
                                                             "set2"])
def test_tol_levels_equals_k4(p):
    band = band_matrix(p)
    got = cost.tol_levels(R, band)
    want = program.tol_cost(R, band)
    assert (got.bytes, got.flops) == (want.hbm_bytes, want.flops)


def test_cost_files_are_the_models():
    """``costs/<function>.py`` maps a call's arguments to the model."""
    from harness import discover
    c = discover.costs()
    p = PARAM_SET_1
    x = torch.zeros((4, p.record_size), dtype=torch.int16)
    got = c["welch_psd"](p, (x, p), {"scales": torch.ones(4)})
    assert got == cost.welch_psd(4, p.record_size, "int16", *_args(p))
    band = torch.as_tensor(band_matrix(p))
    got = c["tol_levels"](p, (torch.zeros((4, p.n_bins)), band), {})
    assert got == cost.tol_levels(4, band.numpy())


def test_cost_adds():
    a, b = cost.Cost(1.0, 2.0), cost.Cost(3.0, 5.0)
    assert (a + b) == cost.Cost(4.0, 7.0)
    assert cost.Cost(3.35e12, 0.0).bound_s == 1.0
    assert cost.Cost(0.0, 67e12).bound == "operations"
