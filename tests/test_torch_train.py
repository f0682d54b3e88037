"""The port's training path (``repro_torch.train.step``,
``optim.adamw``, ``checkpoint.manager``): the reference's own
tests/test_train.py cases run against the port with their assertions
and tolerances, and the port's ``train_step`` held to the reference's on
the same train state and batches.

The reference seeds its init from ``jax.random`` (and ``hash`` of each
path, ROADMAP C6), so the parity test builds the reference's train
state (with a crc32 ``hash``, as ``reference_params`` does) and carries
it across with ``train_state_from_numpy``.  In float64 (the reference
under ``reference_in_float64`` with its step and optimizer modules too,
the port on a float64 state) master, m, v, loss, grad_norm and lr agree
within ``F64_TOL`` (each of master, m and v as a whole tree, against its
largest magnitude: 2.3e-13 at most recorded); in float32 within
``TRAIN_F32_TOL``, fixed by tests/torch_lm_cases.py's rule (1e-4, or 3x
the port's recorded deviation where the reference's own float32 error
against its float64 is larger).  The readings, worst over microbatches
1 and 2 and remat none and block, reference float32 against its float64
/ port float32 against reference float32: master 6.0e-5 / 3.7e-5, m
1.02e-4 / 8.3e-5, v 7.0e-5 / 6.3e-5, loss 1.7e-7 / 1.3e-7, grad_norm
1.8e-4 / 1.6e-4, lr 2.2e-8 / 0.  Adam's update divides by sqrt(v), so
where a grad is near ``eps`` (``blocks/attn/bk``: attention is nearly
invariant to a key bias) a rounding difference moves the master by up
to O(lr); the reference's own float32 master's bk leaf is 0.1 of its
largest magnitude from its float64.
"""
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.module as jmodule
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep
from repro.models import lm as jlm
from torch_lm_cases import (F32_CAP, F64_TOL, Case, as_jax, batch64,
                            make_batch, one_torch_thread,  # noqa: F401
                            reference_in_float64, rel_err)

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=64, vocab=64)
RT = RunSpec(tp=1, remat="none", attn_chunk=64)
OPT = adamw.AdamWConfig(lr_peak=5e-3, warmup_steps=2, total_steps=60)
JOPT = jadamw.AdamWConfig(lr_peak=5e-3, warmup_steps=2, total_steps=60)
PARITY_ARCH = "qwen1.5-0.5b"
pytestmark = pytest.mark.usefixtures("one_torch_thread")
TRAIN_F32_TOL = {"m": 3e-4, "grad_norm": 5e-4}     # else F32_CAP


def _tokens(rng, b, s):
    toks = rng.integers(0, CFG.vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "mask": np.ones((b, s), np.float32)}


def _batch(step, b=8, s=16):
    return _tokens(np.random.default_rng(step), b, s)


def _fixed_repeating_batch(b=8, s=16):
    return _tokens(np.random.default_rng(42), b, s)


def _init():
    return trainstep.init_train_state(lm.param_defs(CFG, RT), OPT,
                                      device="cpu")


def _step(rt=RT):
    return trainstep.make_train_step(CFG, rt, OPT,
                                     compute_dtype=torch.float32)


def _leaves(tree):
    return [t for _, t in module.leaves_with_path(tree)]


# -- the reference's tests/test_train.py, against the port --------------------

class TestTraining:
    def test_loss_decreases_on_fixed_batch(self):
        state, fn = _init(), _step()
        batch = _fixed_repeating_batch()
        losses = []
        for _ in range(30):
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.7, losses[::6]

    def test_microbatch_equals_full_batch_grads(self):
        """Gradient accumulation must match the single-shot gradient."""
        state = _init()
        batch = _fixed_repeating_batch(b=8)
        rt_full = RunSpec(tp=1, remat="none", attn_chunk=64, microbatches=1)
        rt_mb = RunSpec(tp=1, remat="block", attn_chunk=64, microbatches=4)
        s1, m1 = _step(rt_full)(state, batch)
        s2, m2 = _step(rt_mb)(state, batch)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
        for a, b in zip(_leaves(s1["opt"]["master"]),
                        _leaves(s2["opt"]["master"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)

    def test_grad_clipping_bounds_update(self):
        _, m = _step()(_init(), _batch(0))
        assert float(m["grad_norm"]) > 0


class TestCheckpoint:
    def test_save_restore_bit_identical(self, tmp_path):
        state, fn = _init(), _step()
        for i in range(3):
            state, _ = fn(state, _batch(i))
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, state)
        mgr.wait()
        restored, step = mgr.restore(state)
        assert step == 3
        for a, b in zip(_leaves(state), _leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    def test_resume_training_equals_uninterrupted(self, tmp_path):
        fn = _step()
        s_a = _init()                       # uninterrupted: 6 steps
        for i in range(6):
            s_a, _ = fn(s_a, _batch(i))
        s_b = _init()                       # interrupted at 3 + resume
        for i in range(3):
            s_b, _ = fn(s_b, _batch(i))
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, s_b)
        mgr.wait()
        restored, step = mgr.restore(s_b)
        for i in range(step, 6):
            restored, _ = fn(restored, _batch(i))
        for a, b in zip(_leaves(s_a["opt"]["master"]),
                        _leaves(restored["opt"]["master"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)

    def test_atomicity_keeps_previous_on_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        state = {"w": torch.arange(4.0)}
        for s in (1, 2, 3):
            mgr.save(s, {"w": state["w"] + s})
        mgr.wait()
        restored, step = mgr.restore(state)
        assert step == 3
        tags = [t for t in os.listdir(tmp_path) if t.startswith("step_")]
        assert len(tags) == 2   # keep=2 gc'd the oldest


class TestCompression:
    def test_quantize_error_feedback_reduces_bias(self):
        from repro_torch.optim.compress import quantize

        rng = np.random.default_rng(0)
        g = torch.as_tensor(rng.standard_normal(512), dtype=torch.float32) \
            * 1e-3
        err = torch.zeros(512)
        total_q = np.zeros(512)
        # accumulate K quantized steps with error feedback: the running sum
        # converges to the true running sum (unbiasedness of EF)
        true_sum = np.zeros(512)
        for i in range(16):
            q, scale, err = quantize(g, err)
            total_q += q.numpy().astype(np.float64) * float(scale)
            true_sum += g.numpy()
        rel = np.linalg.norm(total_q - true_sum) / np.linalg.norm(true_sum)
        assert rel < 0.05


# -- the port's train_step against the reference's ----------------------------

def reference_train_state(jcfg, jrt, opt_cfg):
    """The reference's ``init_train_state`` (PRNGKey 0) with a crc32
    per-leaf seed, as numpy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodule, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        state = jstep.init_train_state(jlm.param_defs(jcfg, jrt), opt_cfg)
    return jax.tree.map(np.asarray, state)


def state64(tree):
    """Float leaves of a numpy or torch tree as float64; the rest kept."""
    if isinstance(tree, dict):
        return {k: state64(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    return tree.astype(np.float64) if tree.dtype == np.float32 else tree


def run_reference(case, arrays, batches, dtype):
    fn = jax.jit(jstep.make_train_step(case.jcfg, case.jrt, JOPT,
                                       compute_dtype=dtype))
    state, metrics = jax.tree.map(jnp.asarray, arrays), []
    for b in batches:
        state, m = fn(state, as_jax(b))
        metrics.append(jax.tree.map(np.asarray, m))
    return jax.tree.map(np.asarray, state), metrics


def run_port(case, state, batches, dtype):
    fn = trainstep.make_train_step(case.cfg, case.rt, OPT,
                                   compute_dtype=dtype)
    metrics = []
    for b in batches:
        state, m = fn(state, b)
        metrics.append(m)
    return state, metrics


def tree_err(got, want) -> float:
    """Largest deviation over a tree relative to the reference tree's
    largest magnitude (as the serving tests take a whole cache leaf)."""
    got, want = dict(module.leaves_with_path(got)), \
        dict(module.leaves_with_path(want))
    assert got.keys() == want.keys()
    dev = max(float(np.abs(np.asarray(got[p], np.float64) - w).max())
              for p, w in want.items())
    return dev / max(float(np.abs(np.asarray(w, np.float64)).max())
                     for w in want.values())


def train_step_errors(got, want):
    """{what: relative error}: master, m and v (each a whole tree), and
    loss, grad_norm and lr over the steps."""
    (gs, gm), (ws, wm) = got, want
    out = {k: tree_err(gs["opt"][k], ws["opt"][k])
           for k in ("master", "m", "v")}
    for k in ("loss", "grad_norm", "lr"):
        out[k] = rel_err([float(m[k]) for m in gm],
                         [float(m[k]) for m in wm])
    assert int(gs["step"]) == int(ws["step"]) == len(gm)
    return out


def train_step_readings(mb, remat, arch=PARITY_ARCH):
    """Two steps of the port's and the reference's train_step from the
    same state on the same batches: {"f64": errors, "f32": errors,
    "ref_f32": the reference's float32 against its float64}."""
    case = Case(arch, remat=remat, microbatches=mb)
    batches = [make_batch(case.cfg, b=4, seed=i) for i in range(2)]
    arrays = reference_train_state(case.jcfg, case.jrt, JOPT)
    state = trainstep.train_state_from_numpy(
        lm.param_defs(case.cfg, case.rt), arrays, "cpu")
    want = run_reference(case, arrays, batches, jnp.float32)
    with reference_in_float64(jstep, jadamw):
        want64 = run_reference(case, state64(arrays),
                               [batch64(b) for b in batches], jnp.float64)
    got = run_port(case, state, batches, torch.float32)
    got64 = run_port(case, state64(state), [batch64(b) for b in batches],
                     torch.float64)
    return {"f64": train_step_errors(got64, want64),
            "f32": train_step_errors(got, want),
            "ref_f32": train_step_errors(want, want64)}


@pytest.mark.parametrize("mb,remat", [(1, "none"), (1, "block"),
                                      (2, "none"), (2, "block")])
def test_train_step_matches_reference(mb, remat):
    r = train_step_readings(mb, remat)
    for what, err in r["f64"].items():
        assert err <= F64_TOL, (f"{what}, float64: {err:.3e} relative to "
                                f"the reference (bound {F64_TOL:.0e})")
    for what, err in r["f32"].items():
        bound = TRAIN_F32_TOL.get(what, F32_CAP)
        assert err <= bound, (f"{what}, float32: {err:.3e} relative to the "
                              f"reference (bound {bound:.0e})")


def test_make_train_step_rejects_batch_axes():
    """The port lays no batch over mesh axes: a ``batch_axes`` other than
    the default raises rather than being ignored."""
    trainstep.make_train_step(CFG, RT, OPT, torch.float32,
                              batch_axes=("data",))
    with pytest.raises(ValueError, match="batch_axes"):
        trainstep.make_train_step(CFG, RT, OPT, torch.float32,
                                  batch_axes=("pod", "data"))
