"""The LM scaffold's parity cases, shared by the tests that hold the
port's models (``repro_torch.models``) to the reference's
(``repro.models``) on the same weights and inputs: test_torch_models*.py
(one file per family), test_torch_lm_scanned*.py, the attention, MoE,
SSD and mesh-decode tests, and the training tests.

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
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
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
#   qwen3-moe-30b-a3b      5.0e-7 / 5.9e-7      1.5e-5 / 1.0e-6
#   arctic-480b            1.3e-5 / 1.3e-5      4.6e-4 / 5.2e-5
#   mamba2-2.7b            2.1e-6 / 2.2e-6      (no attention)
#   zamba2-1.2b            6.1e-5 / 2.8e-5      3.6e-3 / 1.1e-4
F32_TOL = {
    ("internlm2-20b", "scanned"): 7e-4,
    ("starcoder2-7b", "scanned"): 2e-3,
    ("qwen1.5-0.5b", "scanned"): 3e-4,
    ("internvl2-1b", "scanned"): 9e-4,
    ("seamless-m4t-large-v2", "one-shot"): 3e-3,
    ("seamless-m4t-large-v2", "scanned"): 2e-2,
    ("arctic-480b", "scanned"): 2e-4,
    ("zamba2-1.2b", "scanned"): 4e-4,
}
F32_CAP = 1e-4
# every arch of every family the port serves
ARCHS = [a for a in configs.ARCHS
         if configs.get(a).family in lm.FAMILIES]
# the archs with attention (the scanned/one-shot branches); ssm has none
ATTN_ARCHS = [a for a in ARCHS if configs.get(a).family != "ssm"]
# stacks of attention blocks; and of mamba blocks (with the hybrid's
# shared attention sites)
BLOCK_ARCHS = [a for a in ARCHS
               if configs.get(a).family not in ("ssm", "hybrid")]
SSM_ARCHS = [a for a in ARCHS if a not in BLOCK_ARCHS]
# the per-arch tests run in one file per family (test_torch_models_*.py),
# so that --dist loadfile spreads them over the workers
FAMILY_FILES = {
    "dense": ["minicpm3-4b", "internlm2-20b", "starcoder2-7b",
              "qwen1.5-0.5b"],
    "moe": ["qwen3-moe-30b-a3b", "arctic-480b"],
    "ssm": ["mamba2-2.7b", "zamba2-1.2b"],
    "audio_vlm": ["seamless-m4t-large-v2", "internvl2-1b"],
}
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


def drop_free(cfg, rt):
    """``rt`` with an MoE's capacity at the whole batch: capacity depends
    on the tokens of a call by design, so prefill and decode drop
    different assignments unless none drops (the reference's
    test_decode_matches_forward does the same)."""
    if not cfg.n_experts:
        return rt
    return dataclasses.replace(rt, capacity_factor=float(cfg.n_experts))


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
def reference_in_float64(*more):
    """The reference evaluated in float64: jax_enable_x64, and its model
    modules' ``astype(jnp.float32)`` upcasts (norms, attention, RoPE
    angles) read as float64, so no step of it rounds to float32.
    ``more``: further reference modules read so (the training step's
    and the optimizer's)."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in (jlayers, jattention, jblocks, jlm, jmoe, jmamba2, *more):
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


def check_loss(arch):
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


def check_prefill_then_decode(arch):
    """The port's own prefill(S-1) + decode(1) == forward(S) at the last
    position (the reference's test_decode_matches_forward, its
    tolerance, drop-free for an MoE as there)."""
    cfg = configs.get(arch, reduced=True)
    rt = drop_free(cfg, rt_pair()[1])
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


def check_stack_layer_by_layer(arch):
    """stack_input, blocks.apply_block over each layer and head give
    forward's logits bit for bit; a decode step on the layer cache of
    the whole sequence (its last slot rewritten by the decode) gives
    decode_step's after prefill (chip_smoke.py's layer-by-layer route),
    within F64_TOL in float64 (drop-free for an MoE)."""
    cfg = configs.get(arch, reduced=True)
    rt = drop_free(cfg, rt_pair()[1])
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


def check_ssm_stacks_layer_by_layer(arch):
    """The SSM and hybrid stacks one layer at a time (chip_smoke.py's
    route): each mamba block's recurrent decode step of the last token,
    after the chunked block over the others, against the chunked block
    over all of them, and each shared attention site's decode step
    against its full-sequence block, within F64_TOL in float64; the
    layers and head give forward's logits bit for bit."""
    cfg = configs.get(arch, reduced=True)
    rt = rt_pair()[1]
    params = to64(module.init(lm.param_defs(cfg, rt), device="cpu",
                              generator=7))
    batch = batch64(make_batch(cfg))
    x, enc = lm.stack_input(params, batch, cfg, rt)
    assert enc is None
    x0 = x
    pos = torch.arange(S)[None]
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid" and i % cfg.attn_every == 0:
            lora = lm.site_lora(params, i // cfg.attn_every)
            dx, cache = lm._apply_shared(params["shared"], lora, x, x0,
                                         cfg, rt, positions=pos)
            dxd, _ = lm._apply_shared(params["shared"], lora, x[:, -1:],
                                      x0[:, -1:], cfg, rt, positions=None,
                                      cache=cache, pos=S - 1)
            assert_parity(dxd[:, 0], dx[:, -1], F64_TOL, f"site {i}")
            x = x + dx
        lp = blocks.layer(params["blocks"], i)
        y, _ = blocks.apply_mamba_block(lp, x, cfg, rt)
        _, cache = blocks.apply_mamba_block(lp, x[:, :-1], cfg, rt)
        yd, _ = blocks.apply_mamba_block_decode(lp, x[:, -1:], cache, cfg,
                                                rt)
        assert_parity(yd[:, 0], y[:, -1], F64_TOL, f"layer {i}")
        x = y
    np.testing.assert_array_equal(
        lm.head(params, x, cfg).numpy(),
        lm.forward(params, batch, cfg, rt).numpy())


def check_card_matches_cpu(arch):
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
    for chunk, b, s in smoke.lm_card_cases(configs.get(arch)):
        smoke.card_vs_cpu(np, torch, arch, chunk, b, s)


def grad_case(arch):
    """``Case`` for a gradient check: remat per block (the training
    default), an MoE drop-free, a masked tail in the batch."""
    cfg = configs.get(arch, reduced=True)
    kw = {"remat": "block"}
    if cfg.n_experts:
        kw["capacity_factor"] = float(cfg.n_experts)
    case = Case(arch, **kw)
    mask = np.ones_like(case.batch["mask"])
    mask[:, -3:] = 0.0
    case.batch = dict(case.batch, mask=mask)
    return case


def reference_loss_grads(case, arrays, batch):
    """(loss, {path: grad}) of the reference's ``loss_fn`` by
    ``jax.value_and_grad``."""
    loss, grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, as_jax(batch), case.jcfg, case.jrt))(
        jax.tree.map(jnp.asarray, arrays))
    flat, _ = jax.tree.flatten_with_path(grads)
    return loss, {"/".join(str(k.key) for k in path): np.asarray(g)
                  for path, g in flat}


def port_loss_grads(case, params, batch, dtype):
    """(loss, {path: grad}) of the port's ``loss_fn`` by
    ``train.step.value_and_grad`` over compute params of ``dtype``."""
    from repro_torch.train import step as tstep

    tree = tstep.compute_params(params, dtype)
    loss, grads = tstep.value_and_grad(tree, batch, case.cfg, case.rt)
    return loss, {p: g for (p, _), g in zip(module.leaves_with_path(tree),
                                            grads)}


def leaf_errors(got, want):
    """{path: relative error of the leaf against its largest magnitude};
    a leaf whose reference grad is all zero must be all zero."""
    out = {}
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = np.asarray(got[path], np.float64)
        scale = np.abs(np.asarray(w, np.float64)).max()
        out[path] = (float(np.abs(g - w).max() / scale) if scale
                     else float(np.abs(g).max() * np.inf if np.abs(g).max()
                                else 0.0))
    return out


def loss_grad_readings(arch):
    """{"loss"/"grads"} x {"f64", "f32", "ref_f32"}: the port against the
    reference in float64 and float32, and the reference's float32
    against its float64 (the worst leaf for the grads)."""
    case = grad_case(arch)
    arrays, params = case.reference_weights()
    batch = case.batch
    want = reference_loss_grads(case, arrays, batch)
    with reference_in_float64():
        want64 = reference_loss_grads(case, tree64(arrays), batch64(batch))
    got = port_loss_grads(case, params, batch, torch.float32)
    got64 = port_loss_grads(case, to64(params), batch64(batch),
                            torch.float64)
    return {
        "loss": {"f64": rel_err(got64[0], want64[0]),
                 "f32": rel_err(got[0], want[0]),
                 "ref_f32": rel_err(want[0], want64[0])},
        "grads": {k: max(leaf_errors(a[1], b[1]).values())
                  for k, a, b in (("f64", got64, want64), ("f32", got, want),
                                  ("ref_f32", want, want64))},
    }


# The float32 bound of the grads of loss_fn per arch, by the rule above
# (the loss itself is held to F32_TOL of the one-shot branch).  The
# readings, worst leaf, each against its largest magnitude, on the CPU
# (reference float32 against its float64 / port float32 against
# reference float32; float64 port against reference at most 8.4e-12):
#   minicpm3-4b 6.5e-6 / 7.0e-6     internlm2-20b 9.5e-5 / 7.0e-5
#   starcoder2-7b 3.0e-4 / 2.3e-4   qwen1.5-0.5b 3.3e-5 / 2.3e-5
#   arctic-480b 3.2e-5 / 3.6e-5     qwen3-moe-30b-a3b 1.4e-6 / 1.2e-6
#   internvl2-1b 5.1e-4 / 1.2e-3    zamba2-1.2b 3.9e-3 / 1.5e-3
#   mamba2-2.7b 5.2e-6 / 5.6e-6     seamless-m4t-large-v2 6.6e-3 / 7.5e-3
GRAD_F32_TOL = {"starcoder2-7b": 7e-4, "internvl2-1b": 4e-3,
                "zamba2-1.2b": 5e-3, "seamless-m4t-large-v2": 3e-2}


def check_loss_grads(arch):
    """loss_fn's value and its grads on every leaf (the port's
    ``train.step.value_and_grad``) against ``jax.value_and_grad`` of the
    reference's, on the same weights and batch (remat per block, a masked
    tail, an MoE drop-free): float64 within F64_TOL, float32 within
    F32_TOL (the loss) and GRAD_F32_TOL (each grad leaf)."""
    r = loss_grad_readings(arch)
    for what in ("loss", "grads"):
        assert r[what]["f64"] <= F64_TOL, (
            f"{what}, float64: {r[what]['f64']:.3e} relative to the "
            f"reference (bound {F64_TOL:.0e})")
    bounds = {"loss": F32_TOL.get((arch, "one-shot"), F32_CAP),
              "grads": GRAD_F32_TOL.get(arch, F32_CAP)}
    for what, bound in bounds.items():
        assert r[what]["f32"] <= bound, (
            f"{what}, float32: {r[what]['f32']:.3e} relative to the "
            f"reference (bound {bound:.0e})")


# loss_fn at bf16 compute (the reference's default: the params cast to
# bf16, float32 patches and frames kept, mixed products computed at the
# promoted dtype as jnp does) against the reference's: within about one
# bf16 step (2^-7 = 7.8e-3), BF16_LOSS_TOL relative.  The readings on
# the CPU (port bf16 against reference bf16 / reference bf16 against
# its float32): minicpm3-4b 4.8e-4 / 2.2e-4, internlm2-20b 3.6e-4 /
# 2.3e-3, starcoder2-7b 4.8e-4 / 2.0e-3, qwen1.5-0.5b 4.6e-4 / 2.1e-3,
# arctic-480b 1.3e-4 / 4.8e-4, qwen3-moe-30b-a3b 1.8e-4 / 1.0e-4,
# internvl2-1b 2.1e-3 / 2.7e-2, zamba2-1.2b 1.2e-4 / 1.8e-3,
# mamba2-2.7b 9.2e-4 / 1.1e-3, seamless-m4t-large-v2 3.3e-3 / 1.1e-2.
# The bf16 grads are not held leaf by leaf: the reference's own bf16
# grads are 0.06-3 of a leaf's largest magnitude from its float32.
BF16_LOSS_TOL = 1e-2


def check_bf16_loss(arch):
    """The loss at bf16 compute, on ``grad_case``'s weights and batch,
    within BF16_LOSS_TOL of the reference's; the port's bf16 grads are
    finite."""
    from repro_torch.train import step as tstep

    case = grad_case(arch)
    arrays, params = case.reference_weights()
    want = float(jlm.loss_fn(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), arrays),
        as_jax(case.batch), case.jcfg, case.jrt))
    loss, grads = tstep.value_and_grad(
        tstep.compute_params(params, torch.bfloat16), case.batch, case.cfg,
        case.rt)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert_parity(float(loss), want, BF16_LOSS_TOL, "loss, bf16")


@pytest.fixture
def one_torch_thread():
    """Run a test's torch ops on one thread, then restore the count.  A
    reduced model's step is thousands of tiny ops; under the test
    runner's parallel workers, each op parallelised over every core
    waits on the other workers' threads (the audio-LM example's resume
    test took 0.8 s alone and 97.6 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
