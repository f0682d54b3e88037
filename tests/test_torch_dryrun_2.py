"""The dry run's cells (``repro_torch.launch.dryrun``): the meta count
against the count on real CPU tensors, the serving params' partition
axes and every argument's per-device bytes against the reference's
``PartitionSpec``s and ``NamedSharding(AbstractMesh, spec).shard_shape``
at the production meshes, and ``lower_cell`` and ``main`` themselves.

The reference's ``launch/dryrun.py`` forces 512 host devices through
``XLA_FLAGS`` when it is imported; ``reference_dryrun`` restores the
variable at once, so the flag never reaches this process's backend, and
its ``lower_cell`` is only called where it returns before it builds a
mesh of real devices (a skipped cell), with an ``AbstractMesh``."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, NamedSharding

import repro.configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import lm as jlm
from repro.train import step as jstep
import repro_torch.configs as configs
from repro_torch.configs.base import RunSpec
from repro_torch.launch import dryrun, mesh as meshlib, shapes
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep
from test_torch_dryrun import batch_shapes, meta_batch
from test_torch_shapes import axes_leaves, reference_leaves

MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
          "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
# the reference's record keys (src/repro/launch/dryrun.py, lower_cell)
RECORD_KEYS = {
    "arch", "shape", "mesh", "status", "n_devices", "compile_s",
    "flops_per_device", "hbm_bytes_per_device",
    "collective_wire_bytes_per_device", "collective_counts",
    "collective_bytes_by_kind", "xla_cost_analysis", "memory",
    "model_flops_total", "model_flops_per_device", "useful_flops_ratio",
    "compute_s", "memory_s", "collective_s", "dominant",
    "roofline_bound_s", "compute_fraction_of_bound"}


def reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


def reference_shard_bytes(leaves, jmesh):
    """Bytes of one device's shard of each reference ShapeDtypeStruct:
    its ``PartitionSpec``'s ``shard_shape`` over ``jmesh``."""
    return sum(
        int(np.prod(NamedSharding(jmesh, sd.sharding.spec).shard_shape(
            sd.shape))) * np.dtype(sd.dtype).itemsize
        for sd in leaves.values())


def with_specs(sds_tree, spec_tree, jmesh):
    """The reference's (ShapeDtypeStructs, PartitionSpecs) trees as one
    tree of sharded ShapeDtypeStructs, as its dry run builds them."""
    return jax.tree.map(
        lambda s, p: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=NamedSharding(jmesh, p)),
        sds_tree, spec_tree,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "internvl2-1b", "seamless-m4t-large-v2",
                                  "mamba2-2.7b", "zamba2-1.2b"])
def test_meta_count_equals_cpu_count(arch):
    """One reduced arch per family: the train step's flops on ``meta``
    equal its flops on real CPU tensors (same ops, same shapes)."""
    cfg = configs.get(arch, reduced=True)
    rt = RunSpec(tp=1, remat="block")
    defs = lm.param_defs(cfg, rt)
    opt = adamw.AdamWConfig()
    fn = trainstep.make_train_step(cfg, rt, opt,
                                   compute_dtype=torch.float32)
    meta, _ = dryrun.count(fn, trainstep.abstract_train_state(defs)[0],
                           meta_batch(cfg))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(
        rng.integers(0, cfg.vocab, s) if d == np.int32
        else rng.standard_normal(s), dtype=meta_batch(cfg)[k].dtype)
        for k, (s, d) in batch_shapes(cfg).items()}
    batch["mask"] = torch.ones_like(batch["mask"])
    state = trainstep.init_train_state(defs, opt, device="cpu", generator=0)
    cpu, _ = dryrun.count(fn, state, batch)
    assert meta == cpu > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_params_match_reference(arch, mesh_name):
    """The serving params: every leaf's shape, dtype (bf16) and axes,
    TP-only or FSDP(+TP) past FSDP_SERVE_THRESHOLD (arctic-480b only)."""
    jdry = reference_dryrun()
    mesh = meshlib.make_production_mesh(multi_pod=mesh_name == "multi")
    jmesh = MESHES[mesh_name]
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    rt = shapes.runspec_for(cfg, shapes.SHAPES["decode_32k"], mesh)
    jrt = jshapes.runspec_for(jcfg, jshapes.SHAPES["decode_32k"], jmesh)
    dsize = meshlib.data_size(mesh)
    tensors, axes = dryrun._abstract_params(cfg, rt, mesh, dsize)
    got, got_axes = (dict(module.leaves_with_path(tensors)),
                     axes_leaves(tensors, axes))
    want = reference_leaves(jdry._abstract_params(jcfg, jrt, jmesh, dsize))
    assert got.keys() == want.keys() == got_axes.keys()
    for path, t in got.items():
        assert t.is_meta and t.dtype == torch.bfloat16, path
        assert tuple(t.shape) == want[path].shape, path
        assert got_axes[path] == tuple(want[path].sharding.spec), path
    fsdp = axes != module.pspecs(lm.param_defs(cfg, rt))
    assert fsdp == (arch == "arctic-480b")
    assert dryrun.shard_bytes(tensors, axes, mesh) \
        == reference_shard_bytes(want, jmesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_argument_bytes_match_reference_shards(arch, mesh_name):
    """Per-device bytes of the train state (with the compressed step's
    carried errors on the multi-pod mesh) and of each shape's inputs
    (batch, or tokens, caches and position) equal the sums of the
    reference's shard shapes."""
    mesh = meshlib.make_production_mesh(multi_pod=mesh_name == "multi")
    jmesh = MESHES[mesh_name]
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    rt = shapes.runspec_for(cfg, shapes.SHAPES["train_4k"], mesh)
    jrt = jshapes.runspec_for(jcfg, jshapes.SHAPES["train_4k"], jmesh)
    daxes, dsize = meshlib.data_axes(mesh), meshlib.data_size(mesh)
    pods = mesh.shape.get("pod", 0)     # the compressed step's errors
    state, axes = trainstep.abstract_train_state(lm.param_defs(cfg, rt),
                                                 daxes, dsize, n_pods=pods)
    want = reference_leaves(with_specs(*jstep.abstract_train_state(
        jlm.param_defs(jcfg, jrt), daxes, dsize, n_pods=pods), jmesh))
    assert dryrun.shard_bytes(state, axes, mesh) \
        == reference_shard_bytes(want, jmesh)
    for name in shapes.SHAPES:
        tensors, axes = shapes.input_specs(cfg, shapes.SHAPES[name], mesh)
        want = reference_leaves(jshapes.input_specs(
            jcfg, jshapes.SHAPES[name], jmesh))
        assert dryrun.shard_bytes(tensors, axes, mesh) \
            == reference_shard_bytes(want, jmesh), name


@pytest.fixture(scope="module")
def qwen_train_multi():
    return dryrun.lower_cell("qwen1.5-0.5b", "train_4k", True)


def test_lower_cell_train_4k_at_published_width(qwen_train_multi):
    rec = qwen_train_multi
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert RECORD_KEYS <= rec.keys()
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    for key in ("collective_wire_bytes_per_device", "collective_counts",
                "collective_bytes_by_kind", "xla_cost_analysis",
                "collective_s"):
        assert rec[key] is None, key
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["peak_bytes"] is None
    assert rec["memory"]["argument_bytes"] > 0
    assert "n_devices" in rec["per_device_basis"]
    assert "decode_basis" not in rec
    assert rec["dominant"] in ("compute", "memory")
    assert rec["compute_s"] == rec["flops_per_device"] / 989e12
    json.dumps(rec)


@pytest.mark.parametrize("multi", [False, True])
def test_long_500k_skip_matches_reference(multi, monkeypatch):
    jdry = reference_dryrun()
    monkeypatch.setattr(jdry.meshlib, "make_production_mesh",
                        lambda multi_pod=False: MESHES[
                            "multi" if multi_pod else "single"])
    for arch in configs.ARCHS:
        got = dryrun.lower_cell(arch, "long_500k", multi)
        if configs.get(arch).supports_long_context:
            assert got["status"] == "ok", arch
            continue
        assert got == jdry.lower_cell(arch, "long_500k", multi), arch


def test_main_writes_records_and_skips_existing(tmp_path, monkeypatch,
                                                capsys):
    argv = ["dryrun", "--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
            "--both-meshes", "--out", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv)
    dryrun.main()
    paths = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in paths] == [
        "qwen1.5-0.5b__decode_32k__multi.json",
        "qwen1.5-0.5b__decode_32k__single.json"]
    recs = [json.loads(p.read_text()) for p in paths]
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert [r["n_devices"] for r in recs] == [512, 256]
    assert all("decode_step(mesh=mesh)" in r["decode_basis"] for r in recs)
    before = [p.read_text() for p in paths]
    capsys.readouterr()
    dryrun.main()
    assert capsys.readouterr().out.count("[skip]") == 2
    assert [p.read_text() for p in paths] == before
