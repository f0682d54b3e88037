"""The port's sequence-sharded decode (``decode_attn`` / ``mla_decode``
with ``mesh=``, through ``lm.decode_step``) over ``device_mesh(["cpu"] *
4)``: against the port's own unsharded decode, and against the
reference's ``shard_map`` decode on a four-device CPU mesh.

The reference needs four JAX devices, which tests/conftest.py keeps this
process from having, so it runs in a subprocess: this file, run as a
script with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``.
Weights are the reference's own init (``reference_params``), handed to
it in an npz.

Each case: a 15-token prompt, caches of 32 positions, two decode steps
(positions 15 and 16, which fall in two different sequence shards).
Tolerances: against the reference within 1e-10 in float64 and within
tests/torch_lm_cases.py's one-shot float32 bound of the arch
(``F32_TOL``, ``F32_CAP`` = 1e-4 where not listed); against the port's unsharded decode,
which differs only in where the sums over the sequence are split,
within 1e-10 in float64 and ``SPLIT_F32_TOL`` = 1e-5 in float32.
"""
if __name__ == "__main__":
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PROMPT, S_MAX, STEPS = 15, 32, 2
F64_TOL, SPLIT_F32_TOL = 1e-10, 1e-5
# (arch, mesh model size, batch): 4 sequence shards over 'model'; batch
# over 'data' and the sequence over 'model'; the long-context branch
# (batch 1 < the data size: the sequence over data x model)
CASES = [
    ("internlm2-20b", 4, 2),     # GQA
    ("internlm2-20b", 2, 4),
    ("internlm2-20b", 2, 1),
    ("qwen1.5-0.5b", 2, 2),      # MHA with qkv biases
    ("minicpm3-4b", 4, 2),       # MLA, the absorbed decode
    ("minicpm3-4b", 2, 1),
    ("zamba2-1.2b", 2, 2),       # the hybrid's shared attention sites
    ("seamless-m4t-large-v2", 2, 2),   # self caches; cross caches whole
]
# (arch, model, batch) for cache_specs: every family, both branches
SPEC_CASES = [(a, 2, b) for a in ("internlm2-20b", "minicpm3-4b",
                                  "mamba2-2.7b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2",
                                  "qwen3-moe-30b-a3b")
              for b in (4, 1)]


def case_name(arch, model, b):
    return f"{arch}-m{model}-b{b}"


def prompt_tokens(cfg, b):
    return np.random.default_rng(b).integers(
        0, cfg.vocab, (b, PROMPT + STEPS)).astype(np.int32)


def prompt_batch(cfg, b, toks, f64=False):
    batch = {"tokens": toks[:, :PROMPT]}
    if cfg.family == "audio":
        frames = np.random.default_rng(b + 1).standard_normal(
            (b, 2 * PROMPT, cfg.frontend_dim))
        batch["frames"] = frames.astype(np.float64 if f64 else np.float32)
    return batch


# -- the reference, in a four-device subprocess ------------------------------

def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, a in flat.items():
        *keys, last = path.split("/")
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[last] = a
    return out


def reference_main(workdir: str) -> None:
    """Run every case through the reference's mesh decode; write each
    case's step logits and final cache leaves, and the cache_specs
    axes, into ``workdir``."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro.configs as jconfigs
    from repro.configs.base import RunSpec as JRunSpec
    from repro.models import lm as jlm
    from torch_lm_cases import reference_in_float64

    assert len(jax.devices()) == 4
    rt = JRunSpec(tp=1, remat="none", attn_chunk=64)

    def mesh_of(model):
        return jax.sharding.Mesh(
            np.array(jax.devices()).reshape(4 // model, model),
            ("data", "model"))

    def run(cfg, arrays, toks, model, f64):
        b = toks.shape[0]
        dt = jnp.float64 if f64 else jnp.float32
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), arrays)
        batch = {k: jnp.asarray(v) for k, v in
                 prompt_batch(cfg, b, toks, f64).items()}
        _, caches = jlm.prefill(params, batch, cfg, rt, s_max=S_MAX)
        step = jax.jit(lambda p, t, c, pos: jlm.decode_step(
            p, t, c, pos, cfg, rt, mesh=mesh_of(model)))
        # a strongly typed position: under x64 a weak one meets the int32
        # shard index and leaves the cache slot index int32 among int64s
        pos_type = jnp.int64 if f64 else jnp.int32
        out = {}
        for i in range(STEPS):
            pos = PROMPT + i
            logits, caches = step(params, jnp.asarray(toks[:, pos:pos + 1]),
                                  caches, jnp.asarray(pos, pos_type))
            out[f"logits{i}"] = np.asarray(logits)
        for j, c in enumerate(jax.tree.leaves(caches)):
            out[f"cache{j}"] = np.asarray(c)
        return out

    for arch, model, b in CASES:
        name = case_name(arch, model, b)
        cfg = jconfigs.get(arch, reduced=True)
        arrays = _nest(dict(np.load(f"{workdir}/{name}.weights.npz")))
        toks = prompt_tokens(cfg, b)
        np.savez(f"{workdir}/{name}.f32.npz",
                 **run(cfg, arrays, toks, model, False))
        with reference_in_float64():
            np.savez(f"{workdir}/{name}.f64.npz",
                     **run(cfg, arrays, toks, model, True))

    specs = {}
    for arch, model, b in SPEC_CASES:
        cfg = jconfigs.get(arch, reduced=True)
        _, axes = jlm.cache_specs(cfg, rt, b, S_MAX, mesh=mesh_of(model),
                                  enc_len=2 * PROMPT)
        specs[case_name(arch, model, b)] = [
            list(tuple(p)) for p in jax.tree.leaves(
                axes, is_leaf=lambda x: isinstance(x, P))]
    Path(f"{workdir}/specs.json").write_text(json.dumps(specs))


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------

import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.base import RunSpec  # noqa: E402
from repro_torch.launch.mesh import device_mesh  # noqa: E402
from repro_torch.models import attention, lm, module  # noqa: E402
from torch_lm_cases import (F32_CAP, F32_TOL, Case,  # noqa: E402
                               reference_params, rel_err, rt_pair)

RT = rt_pair()[1]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's outputs for every case, from one subprocess."""
    work = tmp_path_factory.mktemp("mesh_reference")
    for arch, model, b in CASES:
        case = Case(arch)
        arrays = reference_params(case.jcfg, case.jrt)
        flat = dict(module.leaves_with_path(arrays))
        np.savez(work / f"{case_name(arch, model, b)}.weights.npz", **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(work)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return work


def port_runs(arch, model, b, dtype):
    """(the mesh decode's step logits and gathered final caches, the
    unsharded decode's) on the reference's weights."""
    case = Case(arch)
    cfg = case.cfg
    arrays = reference_params(case.jcfg, case.jrt)
    params = module.tree_map(lambda t: t.to(dtype), module.from_numpy(
        lm.param_defs(cfg, RT), arrays, "cpu"))
    toks = prompt_tokens(cfg, b)
    batch = prompt_batch(cfg, b, toks, dtype == torch.float64)
    mesh = device_mesh(["cpu"] * 4, model=model)
    _, caches = lm.prefill(params, batch, cfg, RT, S_MAX)
    whole = module.tree_map(torch.clone, caches)
    shards = lm.shard_caches(caches, cfg, mesh, b)
    got, want = [], []
    for i in range(STEPS):
        pos = PROMPT + i
        tok = toks[:, pos:pos + 1]
        g, shards = lm.decode_step(params, tok, shards, pos, cfg, RT,
                                   mesh=mesh)
        w, whole = lm.decode_step(params, tok, whole, pos, cfg, RT)
        got.append(g)
        want.append(w)
    gathered = lm.gather_caches(shards, cfg, mesh, b)
    leaves = [t for _, t in module.leaves_with_path(gathered)]
    return (got, leaves,
            want, [t for _, t in module.leaves_with_path(whole)])


def _check(got, want, tol, what, n=None):
    err = rel_err(got, want, n)
    assert err <= tol, f"{what}: {err:.3e} relative (bound {tol:.0e})"


@pytest.mark.parametrize("arch,model,b", CASES)
def test_mesh_decode_matches_unsharded_and_reference(arch, model, b,
                                                     reference_runs):
    v = configs.get(arch, reduced=True).vocab
    name = case_name(arch, model, b)
    for dtype, key, ref_tol, split_tol in (
            (torch.float64, "f64", F64_TOL, F64_TOL),
            (torch.float32, "f32", F32_TOL.get((arch, "one-shot"), F32_CAP),
             SPLIT_F32_TOL)):
        got, caches, plain, plain_caches = port_runs(arch, model, b, dtype)
        ref = np.load(reference_runs / f"{name}.{key}.npz")
        for i in range(STEPS):
            _check(got[i], plain[i], split_tol, f"{key} step {i} vs "
                   f"unsharded", v)
            _check(got[i], ref[f"logits{i}"], ref_tol,
                   f"{key} step {i} vs reference", v)
        assert len(caches) == len(plain_caches)
        for j, (c, p) in enumerate(zip(caches, plain_caches)):
            assert c.shape == p.shape
            _check(c, p, split_tol, f"{key} cache {j} vs unsharded")
            _check(c, ref[f"cache{j}"], ref_tol, f"{key} cache {j} vs "
                   f"reference")


@pytest.mark.parametrize("arch,model,b", SPEC_CASES)
def test_cache_specs_axes_match_reference(arch, model, b, reference_runs):
    want = json.loads((reference_runs / "specs.json").read_text())[
        case_name(arch, model, b)]
    _, axes = lm.cache_specs(configs.get(arch, reduced=True), RT, b, S_MAX,
                             mesh=device_mesh(["cpu"] * 4, model=model),
                             enc_len=2 * PROMPT)
    assert _axes_leaves(axes) == [[tuple(x) if isinstance(x, list) else x for x in p]
                   for p in want]


def _axes_leaves(tree):
    """The axes tuples of a cache_specs tree, in leaf order."""
    if isinstance(tree, tuple) and tree and all(
            isinstance(t, tuple) for t in tree):
        return [x for t in tree for x in _axes_leaves(t)]
    return [list(tree)]


def test_layout_of_both_branches():
    """Batch over data and the sequence over model when the batch
    divides; otherwise the sequence over every axis, shard index data-
    major, the batch whole on every shard."""
    mesh = device_mesh(["cpu"] * 4, model=2)
    lay = attention.decode_shards(mesh, 4)
    assert (lay.dp_axes, lay.seq_axes) == (("data",), ("model",))
    assert [(r.start, r.stop, di, si) for _, r, di, si in lay.shards] == [
        (0, 2, 0, 0), (0, 2, 0, 1), (2, 4, 1, 0), (2, 4, 1, 1)]
    assert lay.groups == ((0, 1), (2, 3))
    lay = attention.decode_shards(mesh, 1)
    assert (lay.dp_axes, lay.seq_axes) == ((), ("data", "model"))
    assert [(r.start, r.stop, si) for _, r, _, si in lay.shards] == [
        (0, 1, 0), (0, 1, 1), (0, 1, 2), (0, 1, 3)]
    assert lay.groups == ((0, 1, 2, 3),)
    buf = torch.arange(2 * 4 * 3 * 8 * 2, dtype=torch.float32).reshape(
        2, 4, 3, 8, 2)
    lay = attention.decode_shards(mesh, 4)
    parts = lay.split(buf)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 3, 4, 2)] * 4
    assert torch.equal(parts[3], buf[:, 2:, :, 4:])
    assert torch.equal(lay.gather(parts), buf)
    with pytest.raises(ValueError, match="equal sequence shards"):
        attention.decode_shards(mesh, 1).split(buf[..., :7, :])


def test_only_the_owning_shard_writes_the_slot():
    """A decode step writes its new k/v into the one shard that holds
    the position; every other shard keeps its bits."""
    arch, model, b = "internlm2-20b", 4, 2
    cfg = configs.get(arch, reduced=True)
    params = module.init(lm.param_defs(cfg, RT), device="cpu", generator=4)
    toks = prompt_tokens(cfg, b)
    mesh = device_mesh(["cpu"] * 4, model=model)
    _, caches = lm.prefill(params, prompt_batch(cfg, b, toks), cfg, RT,
                           S_MAX)
    shards = lm.shard_caches(caches, cfg, mesh, b)
    before = module.tree_map(torch.clone, shards)
    lm.decode_step(params, toks[:, PROMPT:PROMPT + 1], shards, PROMPT, cfg,
                   RT, mesh=mesh)
    s_loc = S_MAX // 4
    for leaf, old in zip(shards, before):           # k, then v
        for si, (new, prev) in enumerate(zip(leaf, old)):
            if si == PROMPT // s_loc:
                slot = PROMPT % s_loc
                assert not torch.equal(new[..., slot, :], prev[..., slot, :])
                keep = [i for i in range(s_loc) if i != slot]
                assert torch.equal(new[..., keep, :], prev[..., keep, :])
            else:
                assert torch.equal(new, prev)


def test_mesh_decode_refuses_mixed_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        device_mesh(["cpu", "cuda:0"])
