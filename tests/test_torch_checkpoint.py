"""Checkpoints across the two packages, the training loop's resume,
the card default, and the port's example scripts.

A checkpoint is a directory of ``leaf_<i>.npy`` files numbered in the
tree-flatten order (dict keys sorted) and a ``LATEST`` pointer, in both
packages, so a train state written by either restores in the other.
"""
import importlib.util
import os
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import repro.models.module as jmodule
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep
from torch_lm_cases import Case, as_jax, make_batch, one_torch_thread  # noqa

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_torch_thread")
OPT = dict(lr_peak=5e-3, warmup_steps=1, total_steps=20)


@pytest.fixture(scope="module")
def reference_state():
    """(case, the reference's train state: crc32 leaf seeds, 2 pods of
    error feedback, after one step so that m and v are not zero)."""
    case = Case("qwen1.5-0.5b")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodule, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        from repro.models import lm as jlm
        state = jstep.init_train_state(jlm.param_defs(case.jcfg, case.jrt),
                                       jadamw.AdamWConfig(**OPT), n_pods=2)
    fn = jstep.make_train_step(case.jcfg, case.jrt,
                               jadamw.AdamWConfig(**OPT),
                               compute_dtype=jax.numpy.float32)
    new, _ = fn({k: v for k, v in state.items() if k != "err"},
                as_jax(make_batch(case.cfg)))
    new["err"] = state["err"]
    return case, new


def _assert_same(a, b):
    la, lb = module.leaves_with_path(a), module.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_reference_checkpoint_restores_in_the_port(tmp_path,
                                                   reference_state):
    case, jstate = reference_state
    mgr = JManager(str(tmp_path))
    mgr.save(7, jstate)
    mgr.wait()
    defs = lm.param_defs(case.cfg, case.rt)
    template = trainstep.init_train_state(defs, adamw.AdamWConfig(**OPT),
                                          device="cpu", n_pods=2)
    restored, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 7
    arrays = jax.tree.map(np.asarray, jstate)
    _assert_same(module.tree_map(lambda t: t.numpy(), restored),
                 module.tree_map(lambda t: t.numpy(),
                                 trainstep.train_state_from_numpy(
                                     defs, arrays, "cpu")))
    _assert_same(module.tree_map(lambda t: t.numpy(), restored), arrays)


def test_port_checkpoint_restores_in_the_reference(tmp_path,
                                                   reference_state):
    case, jstate = reference_state
    defs = lm.param_defs(case.cfg, case.rt)
    state = trainstep.train_state_from_numpy(
        defs, jax.tree.map(np.asarray, jstate), "cpu")
    fn = trainstep.make_train_step(case.cfg, case.rt,
                                   adamw.AdamWConfig(**OPT),
                                   compute_dtype=torch.float32)
    state, _ = fn(state, make_batch(case.cfg, seed=1))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(8, state)
    mgr.wait()
    restored, step = JManager(str(tmp_path)).restore(jstate)
    assert step == 8
    _assert_same(jax.tree.map(np.asarray, restored),
                 module.tree_map(lambda t: t.numpy(), state))


def test_restore_checks_the_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore({"w": torch.zeros(3)}) == (None, None)
    mgr.save(1, {"w": torch.arange(3.0), "z": torch.zeros(2)})
    mgr.wait()
    with pytest.raises(ValueError, match="holds 2 leaves"):
        mgr.restore({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="w: stored shape"):
        mgr.restore({"w": torch.zeros(4), "z": torch.zeros(2)})
    got, _ = mgr.restore({"w": torch.zeros(3, dtype=torch.float64),
                          "z": torch.empty(2, device="meta")}, device="cpu")
    assert got["w"].dtype == torch.float64 and got["z"].device.type == "cpu"


def _final_state(root, defs):
    template = trainstep.init_train_state(defs, adamw.AdamWConfig(),
                                          device="cpu")
    return CheckpointManager(str(root)).restore(template)


def test_train_loop_resumes_exactly(tmp_path):
    """``launch.train.run`` on the CPU, stopped after the checkpoint of
    step 3 (the later checkpoint removed and LATEST pointed back, as a
    crash leaves them) and run again: it resumes at step 3, with the
    data of steps 3-5, and ends in the uninterrupted run's state, bit for
    bit."""
    kw = dict(arch="qwen1.5-0.5b", reduced=True, steps=6, batch=4, seq=16,
              ckpt_every=3, device="cpu")
    full = launch_train.run(ckpt_dir=str(tmp_path / "a"), **kw)
    launch_train.run(ckpt_dir=str(tmp_path / "b"), **kw)
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    (tmp_path / "b" / "LATEST").write_text("step_00000003")
    resumed = launch_train.run(ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed == full[3:]
    cfg = launch_train.configs.get("qwen1.5-0.5b", reduced=True)
    defs = lm.param_defs(cfg, launch_train.RunSpec())
    (a, sa), (b, sb) = (_final_state(tmp_path / d, defs) for d in "ab")
    assert sa == sb == 6
    _assert_same(module.tree_map(lambda t: t.numpy(), a),
                 module.tree_map(lambda t: t.numpy(), b))


def test_synth_batch_is_a_function_of_the_step():
    cfg = launch_train.configs.get("seamless-m4t-large-v2", reduced=True)
    a = launch_train.synth_batch(cfg, 2, 8, 5, "cpu")
    b = launch_train.synth_batch(cfg, 2, 8, 5, "cpu")
    c = launch_train.synth_batch(cfg, 2, 8, 6, "cpu")
    assert set(a) == {"tokens", "labels", "mask", "frames"}
    assert a["frames"].shape == (2, 32, cfg.frontend_dim)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, 1))


def test_default_device_is_the_card(monkeypatch, tmp_path, capsys):
    case = Case("qwen1.5-0.5b")
    defs = lm.param_defs(case.cfg, case.rt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainstep.init_train_state(defs, adamw.AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.synth_batch(case.cfg, 1, 4, 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2)})
    mgr.wait()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore({"w": torch.empty(2, device="meta")})
    for main in (launch_train.main, *(_example(n).main for n in EXAMPLES)):
        argv = ["--arch", "qwen1.5-0.5b"] if main is launch_train.main \
            else []
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err


EXAMPLES = {
    "torch_quickstart": ["--record-sec", "0.25"],
    "torch_soundscape_ltsa": ["--record-sec", "0.25"],
    "torch_train_audio_lm": ["--steps", "8", "--batch", "2", "--frames",
                             "32"],
}


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = [*EXAMPLES[name], "--device", "cpu"]
    if name == "torch_train_audio_lm":
        args += ["--ckpt-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, f"examples/{name}.py", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    if name == "torch_train_audio_lm":
        assert (tmp_path / "LATEST").read_text() == "step_00000008"


def test_audio_example_resumes_exactly(tmp_path):
    """The audio-LM example's ``run``: 4 steps with a checkpoint, then
    the same 6-step run resumed from it, equals 6 steps uninterrupted."""
    ex = _example("torch_train_audio_lm")
    kw = dict(steps=6, batch=2, frames=32, device="cpu", ckpt_every=4)
    full = ex.run(ckpt_dir=str(tmp_path / "a"), **kw)
    ex.run(ckpt_dir=str(tmp_path / "b"), **kw)
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    (tmp_path / "b" / "LATEST").write_text("step_00000004")
    assert ex.run(ckpt_dir=str(tmp_path / "b"), **kw) == full[4:]
