"""The port's LM serving path (``repro_torch.models``) against the
reference (``repro.models``) on the same weights and inputs.

Weights come from the reference's ``module.init`` in this process and
reach the port through ``module.from_numpy``.  The reference seeds each
leaf from ``hash(path)``, which Python randomises per process (ROADMAP
C6); ``reference_params`` gives that module a crc32 ``hash`` for the
duration of its init, so every run compares the same weights.

Tolerance.  Every case is run twice in each package.  In float64 (the
reference under jax_enable_x64 with its float32 upcasts read as float64,
``reference_in_float64``; the port on float64 copies of the weights)
the port is held to the reference within ``F64_TOL`` = 1e-10 of the
reference's largest magnitude, over the logical vocabulary or a whole
cache leaf: the two evaluate the same formulas and differ only in the
order of float64 sums (at most 7.6e-12 recorded).  In float32 the port
is held to the reference's float32 within ``F32_TOL``, a fixed constant
per arch and attention branch: 1e-4, except where the reference's own
float32 error (its float32 against its float64) is larger than 1e-4 --
there 3x the port's recorded deviation, rounded up.  Both bounds are
fixed; neither depends on the port's output.  The readings are listed
beside ``F32_TOL`` and come from ``scripts/lm_parity_readings.py``.
The audio backbone is the noisiest: its attention at the reference's
init is sharply peaked (ROADMAP C8).  In the scanned branch the float32
RoPE angles of both packages are up to 2.4e-4 rad from float64 at
position 2100, which moves every float32 run away from the float64 one
together.
"""
import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.module as jmodule
from repro.configs.base import RunSpec as JRunSpec
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
import repro_torch.configs as configs
from repro_torch.configs.base import RunSpec
from repro_torch.models import blocks, lm, module

ROOT = Path(__file__).resolve().parents[1]
F64_TOL = 1e-10
# (arch, branch) -> float32 bound.  The readings, worst over forward,
# prefill, decode and every cache leaf, on the CPU (reference float32
# against its float64 / port float32 against reference float32):
#   arch                   one-shot             scanned
#   minicpm3-4b            4.9e-7 / 7.0e-7      2.2e-5 / 9.1e-7
#   internlm2-20b          1.8e-5 / 1.7e-5      1.9e-3 / 2.3e-4
#   starcoder2-7b          2.6e-5 / 2.6e-5      1.7e-3 / 4.3e-4
#   qwen1.5-0.5b           5.6e-6 / 4.8e-6      7.0e-4 / 9.3e-5
#   internvl2-1b           3.3e-5 / 3.6e-5      2.8e-3 / 2.9e-4
#   seamless-m4t-large-v2  7.4e-4 / 8.4e-4      6.3e-2 / 4.1e-3
F32_TOL = {
    ("internlm2-20b", "scanned"): 7e-4,
    ("starcoder2-7b", "scanned"): 2e-3,
    ("qwen1.5-0.5b", "scanned"): 3e-4,
    ("internvl2-1b", "scanned"): 9e-4,
    ("seamless-m4t-large-v2", "one-shot"): 3e-3,
    ("seamless-m4t-large-v2", "scanned"): 2e-2,
}
F32_CAP = 1e-4
# the attention families' archs (moe, ssm and hybrid come with ROADMAP A9b)
ARCHS = [a for a in configs.ARCHS
         if configs.get(a).family in lm.FAMILIES]
DEFERRED = [a for a in configs.ARCHS if a not in ARCHS]
S = 16
# (attn_chunk, batch, tokens): one-shot attention; the scanned online
# softmax, which runs only past max(chunk, 2048) keys (2100 = 4 chunks of
# 512 and a ragged one).  The audio backbone's encoder sees two frames a
# token: 2100 frames under 1050 decoder tokens (scanned encoder and cross
# attention, one-shot decoder self-attention).
BRANCHES = {"one-shot": (64, 2, S), "scanned": (512, 1, 2100)}


def rt_pair(**kw):
    kw = {"tp": 1, "remat": "none", "attn_chunk": 64, **kw}
    return JRunSpec(**kw), RunSpec(**kw)


def make_batch(cfg, b=2, s=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones((b, s), np.float32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, 2 * s, cfg.frontend_dim)).astype(np.float32)
    return batch


def reference_params(cfg, jrt, key=0):
    """The reference's own init, with a stable per-leaf seed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodule, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        params = jmodule.init(jax.random.PRNGKey(key),
                              jlm.param_defs(cfg, jrt))
    return jax.tree.map(np.asarray, params)


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return getattr(jnp, "float64" if name == "float32" else name)


@contextlib.contextmanager
def reference_in_float64():
    """The reference evaluated in float64: jax_enable_x64, and its model
    modules' ``astype(jnp.float32)`` upcasts (norms, attention, RoPE
    angles) read as float64, so no step of it rounds to float32."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in (jlayers, jattention, jblocks, jlm):
            mp.setattr(mod, "jnp", _Float64Numpy())
        yield


def tree64(arrays):
    return jax.tree.map(lambda a: a.astype(np.float64), arrays)


def to64(tree):
    return module.tree_map(lambda t: t.double(), tree)


def batch64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def rel_err(got, want, n=None):
    got = np.atleast_1d(np.asarray(got, np.float64))[..., :n]
    want = np.atleast_1d(np.asarray(want, np.float64))[..., :n]
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_parity(got, want, bound, what, n=None):
    err = rel_err(got, want, n)
    assert err <= bound, (f"{what}: {err:.3e} relative to the reference "
                          f"(bound {bound:.1e})")
    return err


def outputs_match(got, want, bound, v):
    """Logits over the logical vocabulary ``v``, caches leaf by leaf."""
    for i, what in ((0, "forward"), (1, "prefill logits"),
                    (3, "decode logits")):
        assert_parity(got[i], want[i], bound, what, v)
    for name, i in (("prefill cache", 2), ("decoded cache", 4)):
        assert len(got[i]) == len(want[i])
        for g, w in zip(got[i], want[i]):
            assert tuple(g.shape) == tuple(np.shape(w)), name
            assert_parity(g, w, bound, name)


def leaves(tree):
    return [t for _, t in module.leaves_with_path(tree)]


class Case:
    """One arch's inputs and the three entry points' outputs: in the
    reference on its own weights (``run_ref``), in the port on any tree
    (``run_port``)."""

    def __init__(self, arch, branch="one-shot", **rt_kw):
        chunk, b, self.s = BRANCHES[branch]
        if branch == "scanned" and arch == "seamless-m4t-large-v2":
            self.s //= 2
        self.jcfg = jconfigs.get(arch, reduced=True)
        self.cfg = configs.get(arch, reduced=True)
        self.jrt, self.rt = rt_pair(attn_chunk=chunk, **rt_kw)
        self.batch = make_batch(self.cfg, b=b, s=self.s)
        self.extra = (self.cfg.n_frontend_tokens
                      if self.cfg.family == "vlm" else 0)
        self.s_max = self.s + 4 + self.extra
        self.pos = self.s - 1 + self.extra
        self.prompt = dict(self.batch,
                           tokens=self.batch["tokens"][:, : self.s - 1])
        self.last = self.batch["tokens"][:, self.s - 1:]

    def reference_weights(self):
        """(the reference's weights as numpy, the port's tree of them)."""
        arrays = reference_params(self.jcfg, self.jrt)
        defs = lm.param_defs(self.cfg, self.rt)
        return arrays, module.from_numpy(defs, arrays, "cpu")

    def run_ref(self, arrays, eager=False, f64=False):
        """The reference's outputs; ``eager`` runs its layer scans op by
        op (``jax.disable_jit``), without the compiled scan body's RoPE
        angle error (ROADMAP C7); ``f64`` evaluates it in float64."""
        if f64:
            with reference_in_float64():
                return self.run_ref(tree64(arrays), eager)
        if eager:
            with jax.disable_jit():
                return self.run_ref(arrays)
        jp = jax.tree.map(jnp.asarray, arrays)
        batch = batch64(self.batch) if jax.config.jax_enable_x64 \
            else self.batch
        prompt = dict(batch, tokens=self.prompt["tokens"])
        fwd = jlm.forward(jp, as_jax(batch), self.jcfg, self.jrt)
        logits, caches = jlm.prefill(jp, as_jax(prompt), self.jcfg,
                                     self.jrt, s_max=self.s_max)
        cache_l = [np.asarray(c) for c in jax.tree.leaves(caches)]
        dec, dcaches = jlm.decode_step(
            jp, jnp.asarray(self.last), caches, jnp.asarray(self.pos),
            self.jcfg, self.jrt)
        return fwd, logits, cache_l, dec, jax.tree.leaves(dcaches)

    def run_port(self, params, f64=False):
        batch = batch64(self.batch) if f64 else self.batch
        params = to64(params) if f64 else params
        fwd = lm.forward(params, batch, self.cfg, self.rt)
        prompt = dict(batch, tokens=self.prompt["tokens"])
        logits, caches = lm.prefill(params, prompt, self.cfg, self.rt,
                                    self.s_max)
        cache_l = [c.clone() for c in leaves(caches)]
        dec, dcaches = lm.decode_step(params, self.last, caches, self.pos,
                                      self.cfg, self.rt)
        return fwd, logits, cache_l, dec, leaves(dcaches)


def check_serving_path(arch, branch, eager=False, **rt_kw):
    """forward logits, prefill's last logits and every cache leaf, and
    decode_step's logits and updated caches, in float64 and float32."""
    case = Case(arch, branch, **rt_kw)
    arrays, params = case.reference_weights()
    got = case.run_port(params)
    v = case.cfg.vocab
    b = case.batch["tokens"].shape[0]
    assert got[0].shape == (b, case.s, case.cfg.padded_vocab)
    assert got[1].shape == (b, case.cfg.padded_vocab)
    outputs_match(case.run_port(params, f64=True),
                  case.run_ref(arrays, f64=True), F64_TOL, v)
    outputs_match(got, case.run_ref(arrays, eager),
                  F32_TOL.get((arch, branch), F32_CAP), v)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch):
    """One-shot attention (tests/test_torch_lm_scanned.py takes the
    scanned branch)."""
    check_serving_path(arch, "one-shot")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """loss_fn, forward only: the masked mean cross-entropy."""
    case = Case(arch)
    arrays, params = case.reference_weights()
    mask = np.ones_like(case.batch["mask"])
    mask[:, -3:] = 0.0                          # a masked tail counts
    batch = dict(case.batch, mask=mask)
    want = jlm.loss_fn(jax.tree.map(jnp.asarray, arrays), as_jax(batch),
                       case.jcfg, case.jrt)
    got = lm.loss_fn(params, batch, case.cfg, case.rt)
    with reference_in_float64():
        want64 = jlm.loss_fn(jax.tree.map(jnp.asarray, tree64(arrays)),
                             as_jax(batch64(batch)), case.jcfg, case.jrt)
    got64 = lm.loss_fn(to64(params), batch64(batch), case.cfg, case.rt)
    assert got.shape == ()
    assert_parity(got64, want64, F64_TOL, "loss, float64")
    assert_parity(got, want, F32_TOL.get((arch, "one-shot"), F32_CAP),
                  "loss")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port's own prefill(S-1) + decode(1) == forward(S) at the last
    position (the reference's test_decode_matches_forward, its
    tolerance)."""
    cfg = configs.get(arch, reduced=True)
    rt = rt_pair()[1]
    params = module.init(lm.param_defs(cfg, rt), device="cpu", generator=0)
    batch = make_batch(cfg)
    full = lm.forward(params, batch, cfg, rt)[:, -1]
    extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    prompt = dict(batch, tokens=batch["tokens"][:, : S - 1])
    _, caches = lm.prefill(params, prompt, cfg, rt, s_max=S + 4 + extra)
    logits, _ = lm.decode_step(params, batch["tokens"][:, S - 1:], caches,
                               S - 1 + extra, cfg, rt)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_input_drives_the_stack_layer_by_layer(arch):
    """stack_input, blocks.apply_block over each layer and head give
    forward's logits bit for bit; a decode step on the layer cache of
    the whole sequence (its last slot rewritten by the decode) gives
    decode_step's after prefill (chip_smoke.py's layer-by-layer route),
    within F64_TOL in float64."""
    cfg = configs.get(arch, reduced=True)
    rt = rt_pair()[1]
    params = to64(module.init(lm.param_defs(cfg, rt), device="cpu",
                              generator=7))
    batch = batch64(make_batch(cfg))
    x, enc = lm.stack_input(params, batch, cfg, rt)
    extra = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    assert x.shape == (2, S + extra, cfg.d_model)
    assert (enc is None) == (cfg.family != "audio")
    pos = torch.arange(S + extra)[None]
    for i in range(cfg.n_layers):
        lp = blocks.layer(params["blocks"], i)
        y, cache = blocks.apply_block(lp, x, cfg, rt, positions=pos,
                                      enc_out=enc)
        yd, _ = blocks.apply_block_decode(lp, x[:, -1:], cache,
                                          S - 1 + extra, cfg, rt)
        x = y
    np.testing.assert_array_equal(
        lm.head(params, x[:, extra:], cfg).numpy(),
        lm.forward(params, batch, cfg, rt).numpy())
    prompt = dict(batch, tokens=batch["tokens"][:, : S - 1])
    _, caches = lm.prefill(params, prompt, cfg, rt, S + extra)
    want, _ = lm.decode_step(params, batch["tokens"][:, S - 1:], caches,
                             S - 1 + extra, cfg, rt)
    assert_parity(lm.head(params, yd[:, 0], cfg), want, F64_TOL, "decode",
                  cfg.vocab)


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


@pytest.mark.parametrize("arch", DEFERRED)
def test_deferred_families_raise_naming_next_slice(arch):
    cfg = configs.get(arch, reduced=True)
    rt = RunSpec()
    for call in (lambda: lm.param_defs(cfg, rt),
                 lambda: lm.forward({}, {}, cfg, rt),
                 lambda: lm.prefill({}, {}, cfg, rt, 8),
                 lambda: lm.decode_step({}, None, None, 0, cfg, rt),
                 lambda: lm.cache_specs(cfg, rt, 1, 8)):
        with pytest.raises(NotImplementedError, match="9b"):
            call()


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
                                  "internvl2-1b"])
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


def test_mesh_decode_is_not_ported():
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    rt = rt_pair()[1]
    params = module.init(lm.param_defs(cfg, rt), device="cpu")
    batch = make_batch(cfg)
    _, caches = lm.prefill(params, batch, cfg, rt, S + 2)
    with pytest.raises(NotImplementedError, match="9b"):
        lm.decode_step(params, batch["tokens"][:, -1:], caches, S, cfg, rt,
                       mesh=object())


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(arch):
    """The same weights on cuda and on the CPU: forward, prefill and
    decode logits within 1e-10 in float64 and within chip_smoke.py's
    fixed float32 bounds (its phase 11c, which this runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    for chunk, b, s in smoke.LM_CARD_CASES:
        smoke.card_vs_cpu(np, torch, arch, chunk, b, s)
