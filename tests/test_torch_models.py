"""The port's LM serving path (``repro_torch.models``) against the
reference (``repro.models``): the tests that are not per arch, or cheap
for every arch.  The per-arch parity tests run in one file per family
(test_torch_models_{dense,moe,ssm,audio_vlm}.py); their cases, weights
and bounds are in tests/torch_lm_cases.py.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import repro.configs as jconfigs
import repro.models.module as jmodule
from repro.configs.base import RunSpec as JRunSpec
from repro.models import lm as jlm
import repro_torch.configs as configs
from repro_torch.configs.base import RunSpec
from repro_torch.models import lm, module
from torch_lm_cases import (ARCHS, FAMILY_FILES, ROOT, S, leaves, make_batch,
                            rt_pair)


def test_every_arch_has_one_family_file():
    assert sorted(a for f in FAMILY_FILES.values() for a in f) \
        == sorted(ARCHS)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-1b"])
def test_embed_via_matmul_equals_gather(arch):
    cfg = configs.get(arch, reduced=True)
    rt = rt_pair()[1]
    params = module.init(lm.param_defs(cfg, rt), device="cpu", generator=1)
    batch = make_batch(cfg)
    want = lm.forward(params, batch, cfg, rt)
    got = lm.forward(params, batch, cfg,
                     dataclasses.replace(rt, embed_via_matmul=True))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_reference_at_full_width(arch):
    """Paths, shapes, partition axes and counts of the full configs, from
    meta tensors (nothing allocated)."""
    jrt, rt = rt_pair()
    jdefs = jlm.param_defs(jconfigs.get(arch), jrt)
    defs = lm.param_defs(configs.get(arch), rt)
    flat, _ = jax.tree.flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jmodule.ParamDef))
    want = {"/".join(str(k.key) for k in path): d for path, d in flat}
    got = dict(module.leaves_with_path(defs))
    assert got.keys() == want.keys()
    for path, d in got.items():
        w = want[path]
        assert (d.shape, d.pspec, d.init, d.scale) == (
            w.shape, tuple(w.pspec), w.init, w.scale), path
    meta = dict(module.leaves_with_path(module.abstract(defs)))
    assert all(t.is_meta and tuple(t.shape) == got[p].shape
               for p, t in meta.items())
    assert module.count_params(defs) == jmodule.count_params(jdefs)


def test_every_family_is_served():
    assert set(lm.FAMILIES) == {"dense", "moe", "vlm", "hybrid", "ssm",
                                "audio"}
    assert ARCHS == configs.ARCHS


def test_configs_copy_the_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    for arch in configs.ARCHS:
        for reduced in (False, True):
            assert (dataclasses.asdict(configs.get(arch, reduced))
                    == dataclasses.asdict(jconfigs.get(arch, reduced)))
    assert (dataclasses.asdict(RunSpec())
            == dataclasses.asdict(JRunSpec()))


def test_init_is_the_same_in_two_processes():
    """Per-leaf seeds are crc32 digests of the path, so two interpreters
    (each with its own str-hash seed) give the same weights."""
    code = (
        "import hashlib, json\n"
        "import repro_torch.configs as c\n"
        "from repro_torch.configs.base import RunSpec\n"
        "from repro_torch.models import lm, module\n"
        "cfg = c.get('qwen1.5-0.5b', reduced=True)\n"
        "p = module.init(lm.param_defs(cfg, RunSpec()), device='cpu',\n"
        "                generator=3)\n"
        "print(json.dumps({k: hashlib.sha256(t.numpy().tobytes())\n"
        "                  .hexdigest() for k, t in\n"
        "                  module.leaves_with_path(p)}))\n")
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=seed)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout))
    assert outs[0] == outs[1]
    assert len(set(outs[0].values())) > 10      # leaves differ from each other


def test_init_seed_and_generator():
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    defs = lm.param_defs(cfg, RunSpec())
    a = module.init(defs, device="cpu", generator=5)
    b = module.init(defs, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    c = module.init(defs, device="cpu", generator=6)
    for (path, x), y, z in zip(module.leaves_with_path(a), leaves(b),
                               leaves(c)):
        assert torch.equal(x, y), path
        if "norm" not in path and not path.endswith(("/bq", "/bk", "/bv")):
            assert not torch.equal(x, z), path
    table = a["embed"]["table"]
    assert abs(float(table.std()) - 1.0) < 0.05        # scale=1.0
    wq = a["blocks"]["attn"]["wq"]                     # fan-in = heads
    assert abs(float(wq.std()) - cfg.n_heads ** -0.5) < 0.05


def test_from_numpy_checks_paths_and_shapes():
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    defs = lm.param_defs(cfg, RunSpec())
    arrays = module.tree_map(lambda t: t.numpy(),
                             module.init(defs, device="cpu"))
    del arrays["final_norm"]["bias"]
    with pytest.raises(ValueError, match="missing.*final_norm/bias"):
        module.from_numpy(defs, arrays, "cpu")
    arrays["final_norm"]["bias"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="final_norm/bias: shape"):
        module.from_numpy(defs, arrays, "cpu")


def test_language_model_module_mirrors_the_tree():
    cfg = configs.get("seamless-m4t-large-v2", reduced=True)
    rt = rt_pair()[1]
    model = lm.LanguageModel(cfg, rt, device="cpu", generator=2)
    defs = lm.param_defs(cfg, rt)
    names = dict(model.named_parameters())
    want = {p.replace("/", ".") for p, _ in module.leaves_with_path(defs)}
    assert {n.removeprefix("params.") for n in names} == want
    assert not any(p.requires_grad for p in names.values())
    params = module.init(defs, device="cpu", generator=2)
    batch = make_batch(cfg)
    np.testing.assert_array_equal(model(batch).numpy(),
                                  lm.forward(params, batch, cfg, rt).numpy())
    prompt = dict(batch, tokens=batch["tokens"][:, :-1])
    logits, caches = model.prefill(prompt, s_max=S + 2)
    want_l, want_c = lm.prefill(params, prompt, cfg, rt, S + 2)
    np.testing.assert_array_equal(logits.numpy(), want_l.numpy())
    got, _ = model.decode_step(batch["tokens"][:, -1:], caches, S - 1)
    want, _ = lm.decode_step(params, batch["tokens"][:, -1:], want_c, S - 1,
                             cfg, rt)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("arch", ["minicpm3-4b", "seamless-m4t-large-v2",
                                  "internvl2-1b", "qwen3-moe-30b-a3b",
                                  "mamba2-2.7b", "zamba2-1.2b"])
def test_cache_specs_match_prefill_caches(arch):
    cfg = configs.get(arch, reduced=True)
    rt = rt_pair()[1]
    params = module.init(lm.param_defs(cfg, rt), device="cpu")
    batch = make_batch(cfg)
    s_max = S + cfg.n_frontend_tokens + 4
    _, caches = lm.prefill(params, batch, cfg, rt, s_max)
    specs, axes = lm.cache_specs(cfg, rt, 2, s_max, dtype=torch.float32,
                                 enc_len=2 * S)
    got = [tuple(c.shape) for c in leaves(caches)]
    assert got == [tuple(t.shape) for t in leaves(specs)]
    assert all(t.is_meta for t in leaves(specs))
    jspecs, _ = jlm.cache_specs(jconfigs.get(arch, reduced=True),
                                rt_pair()[0], 2, s_max, enc_len=2 * S)
    assert got == [tuple(t.shape) for t in jax.tree.leaves(jspecs)]


def test_default_device_is_the_card(monkeypatch):
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.LanguageModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.init(lm.param_defs(cfg, RunSpec()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.from_numpy({}, {})
