"""The port's roofline modules: ``distributed.roofline`` (H100 terms,
``model_flops``) against the reference's, and ``kernels.roofline`` (the
cost model of the seven CUDA kernels) against PERF.md's kernel table and
the tensors of each kernel's call."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed import roofline as jroofline
import repro_torch.configs as configs
from repro_torch.core.params import PARAM_SET_1, PARAM_SET_2, DepamParams
from repro_torch.core.tol import band_matrix
from repro_torch.distributed import roofline
from repro_torch.kernels import (ct_rfft, events, framepsd,
                                 roofline as kroofline, tol, welch)


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_matches_reference(arch, train):
    """Published width, exactly equal: the same parameter count, less
    the embeddings, with the MoE's active share."""
    n = 256 * 4096
    assert roofline.model_flops(configs.get(arch), n, train) \
        == jroofline.model_flops(jconfigs.get(arch), n, train)


def test_h100_constants():
    assert roofline.HBM_BW == 3.35e12
    assert roofline.PEAK_FLOPS == {torch.float32: 67e12,
                                   torch.bfloat16: 989e12}
    assert roofline.LINK_BW == 450e9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roofline_terms_per_device(dtype):
    flops, hbm, wire = 3.0e12, 2.0e10, 9.0e9
    got = roofline.roofline_terms_per_device(flops, hbm, wire, 2.0, dtype)
    want = jroofline.roofline_terms_per_device(flops, hbm, wire)
    assert got.keys() == want.keys()
    c = flops / roofline.PEAK_FLOPS[dtype]
    m = hbm / 3.35e12
    k = wire / (450e9 * 2.0)
    assert (got["compute_s"], got["memory_s"], got["collective_s"]) \
        == (c, m, k)
    top = max(c, m, k)
    assert got["roofline_bound_s"] == top
    assert got["dominant"] == {c: "compute", m: "memory",
                               k: "collective"}[top]
    assert got["compute_fraction_of_bound"] == c / top


def test_unknown_wire_bytes_leave_the_collective_out():
    got = roofline.roofline_terms_per_device(1e9, 3.35e12, None,
                                             dtype=torch.float32)
    assert got["collective_s"] is None
    assert got["dominant"] == "memory" and got["roofline_bound_s"] == 1.0
    got = roofline.roofline_terms_per_device(67e12, 1.0, None,
                                             dtype=torch.float32)
    assert got["dominant"] == "compute" and got["roofline_bound_s"] == 1.0
    assert got["compute_fraction_of_bound"] == 1.0


def test_roofline_terms_spread_over_devices():
    whole = roofline.roofline_terms(8e12, 4e10, 2e9, 4)
    per = roofline.roofline_terms_per_device(2e12, 1e10, 5e8)
    assert whole == per
    assert roofline.roofline_terms(8e12, 4e10, None, 4)["collective_s"] \
        is None


# PERF.md section 6's bounds (ms, three digits) at chip_smoke.py phase 2's
# shapes: 8 records of a paper set a step; K7 over the int16 step of the
# set-2 detection cell with chip_smoke.k7_event_mix's events
BOUNDS_MS = {"K1": 0.0188, "K2": 0.00470, "K3": 0.00159, "K4": 0.000101,
             "K5": 0.0377, "K6": 0.000294, "K7": 0.0000428}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase2_costs():
    p1, p2 = PARAM_SET_1, PARAM_SET_2
    counts7, rows7 = _chip_smoke().k7_event_mix(0, 8, p2)
    span7 = kroofline.event_span_samples(counts7, rows7, p2, p2.record_size)
    return {
        "K7": kroofline.impulsive_metrics_cost(span7, 8, p2.event_capacity,
                                               int16=True),
        "K1": kroofline.welch_psd_cost(8, p1.record_size, p1),
        "K2": kroofline.ct_cost(8 * p2.frames_per_record, p2),
        "K3": kroofline.welch_mean_cost(8, p2.frames_per_record, p2.n_bins),
        "K4": kroofline.tol_cost(8, band_matrix(p2)),
        "K5": kroofline.frame_psd_cost(8, p1.record_size, p1),
        "K6": kroofline.detect_events_cost(8, p1.frames_per_record,
                                           p1.event_capacity)}


@pytest.mark.parametrize("kernel", sorted(BOUNDS_MS))
def test_kernel_bounds_match_perf_table(kernel):
    cost = phase2_costs()[kernel]
    assert cost.bound == "bytes"
    assert cost.bound_s == cost.memory_s >= cost.compute_s
    assert cost.bound_s * 1e3 == pytest.approx(BOUNDS_MS[kernel], rel=1e-2)


def small_calls():
    """(cost, the call's input and output tensors) of each kernel's
    wrapper on small CPU tensors (its plain version), as phase 2 checks
    them on the card: K1 and K5 also on the direct tile's nfft 320."""
    rng = np.random.default_rng(0)
    p, p2 = SMALL, PARAM_SET_2
    x = torch.as_tensor(rng.standard_normal((3, p.record_size)),
                        dtype=torch.float32)
    fr = torch.as_tensor(rng.standard_normal((5, p2.window_size)),
                         dtype=torch.float32)
    fp = torch.as_tensor(rng.random((3, 7, p2.n_bins)), dtype=torch.float32)
    psd = torch.as_tensor(rng.random((3, p2.n_bins)), dtype=torch.float32)
    bm = torch.as_tensor(band_matrix(p2), dtype=torch.float32)
    spl = torch.as_tensor(rng.normal(-20.0, 5.0, (3, 40)),
                          dtype=torch.float32)
    pb = torch.as_tensor(rng.integers(0, p.n_bins, (3, 40)),
                         dtype=torch.int32)
    xd = torch.as_tensor(rng.standard_normal((2, DIRECT.record_size)),
                         dtype=torch.float32)
    ev = events.detect_events(spl, pb, threshold_db=-20.0,
                              hysteresis_db=2.0, capacity=4)
    return {
        "K1": (kroofline.welch_psd_cost(*x.shape, p),
               (x, framepsd.welch_psd(x, p))),
        "K1-direct": (kroofline.welch_psd_cost(*xd.shape, DIRECT),
                      (xd, framepsd.welch_psd(xd, DIRECT))),
        "K2": (kroofline.ct_cost(fr.shape[0], p2),
               (fr, ct_rfft.ct_frame_psd(fr, p2))),
        "K3": (kroofline.welch_mean_cost(*fp.shape),
               (fp, welch.welch_mean(fp))),
        "K4": (kroofline.tol_cost(psd.shape[0], bm.numpy()),
               (psd, bm, tol.tol_levels(psd, bm, p2))),
        "K5": (kroofline.frame_psd_cost(*x.shape, p),
               (x, framepsd.frame_psd(x, p))),
        "K5-direct": (kroofline.frame_psd_cost(*xd.shape, DIRECT),
                      (xd, framepsd.frame_psd(xd, DIRECT))),
        "K6": (kroofline.detect_events_cost(*spl.shape, 4), (spl, pb, *ev)),
    }


SMALL = DepamParams(nfft=256, window_size=256, window_overlap=128,
                    record_size_sec=0.05)
DIRECT = DepamParams(nfft=320, window_size=320, window_overlap=160,
                     record_size_sec=0.05)


@pytest.mark.parametrize("kernel", ["K1", "K1-direct", "K2", "K3", "K4",
                                    "K5", "K5-direct", "K6"])
def test_kernel_cost_bytes_are_the_calls_tensors(kernel):
    """Each cost's bytes are those of its call's inputs and outputs
    (4-byte elements), each once: the check phase 2 makes on the card,
    here on the plain versions' outputs."""
    cost, io = small_calls()[kernel]
    assert all(t.element_size() == 4 for t in io)
    assert cost.hbm_bytes == 4 * sum(t.numel() for t in io)
