"""The port's cell shapes (``launch.shapes``) and production mesh
(``launch.mesh.make_production_mesh``) against the reference's.

The reference's side takes ``jax.sharding.AbstractMesh``es of the
production layouts, so no forced device count is needed: its
``PartitionSpec``s are real, and ``tuple()`` of each is what the port's
axis tuples must equal."""
from types import SimpleNamespace

import pytest
import torch

import jax
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.launch import shapes as jshapes
import repro_torch.configs as configs
from repro_torch import api
from repro_torch.configs.base import RunSpec
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.launch import mesh as meshlib, shapes
from repro_torch.models import module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep

MESHES = ["none", "single", "multi"]


def meshes(name):
    """(port mesh, reference mesh) for one of MESHES."""
    if name == "none":
        return None, None
    multi = name == "multi"
    return (meshlib.make_production_mesh(multi_pod=multi),
            AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else AbstractMesh((16, 16), ("data", "model")))


def reference_leaves(tree):
    """{path: ShapeDtypeStruct} of the reference's tree, paths joined
    as ``module.leaves_with_path`` joins them."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = leaf
    return out


def axes_leaves(tensors, axes):
    """{path: axis tuple} of the port's axes tree, by the tensor tree's
    structure (an axis tuple is a leaf, not a node)."""
    boxed = module.tree_map(lambda t, a: SimpleNamespace(axes=a), tensors,
                            axes)
    return {p: b.axes for p, b in module.leaves_with_path(boxed)}


def test_production_mesh():
    single = meshlib.make_production_mesh()
    multi = meshlib.make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    for m, n in ((single, 256), (multi, 512)):
        assert m.devices.size == n and meshlib.is_meta(m)
        assert all(d == torch.device("meta") for d in m.devices.flat)
    assert (meshlib.data_axes(single), meshlib.data_size(single)) == (
        ("data",), 16)
    assert (meshlib.data_axes(multi), meshlib.data_size(multi)) == (
        ("pod", "data"), 32)
    with pytest.raises(ValueError, match="one device"):
        meshlib.pod_devices(multi)      # no pod of it runs a step
    assert not meshlib.is_meta(meshlib.device_mesh(["cpu"] * 2))


def test_shape_tables_match_reference():
    assert {k: tuple(vars(v).values()) for k, v in shapes.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    assert shapes.MICROBATCHES == jshapes.MICROBATCHES


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_applicable_and_runspec_match_reference(arch, mesh_name):
    mesh, jmesh = meshes(mesh_name)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in shapes.SHAPES:
        s, js = shapes.SHAPES[name], jshapes.SHAPES[name]
        assert shapes.applicable(cfg, s) == jshapes.applicable(jcfg, js)
        got = shapes.runspec_for(cfg, s, mesh)
        want = jshapes.runspec_for(jcfg, js, jmesh)
        assert isinstance(got, RunSpec)
        assert vars(got) == vars(want), (arch, name, mesh_name)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch, mesh_name):
    """Every leaf's path, shape, dtype and partition axes, for the four
    shapes; without a mesh the port's axes are all None (the reference
    sets no sharding)."""
    mesh, jmesh = meshes(mesh_name)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in shapes.SHAPES:
        tensors, axes = shapes.input_specs(cfg, shapes.SHAPES[name], mesh)
        got = dict(module.leaves_with_path(tensors))
        got_axes = axes_leaves(tensors, axes)
        want = reference_leaves(jshapes.input_specs(
            jcfg, jshapes.SHAPES[name], jmesh))
        assert got.keys() == want.keys() == got_axes.keys(), name
        for path, t in got.items():
            w = want[path]
            assert t.is_meta and tuple(t.shape) == tuple(w.shape), path
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
            spec = got_axes[path]
            if jmesh is None:
                assert w.sharding is None and set(spec) <= {None}, path
            else:
                assert spec == tuple(w.sharding.spec), (name, path)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-1b",
                                  "seamless-m4t-large-v2", "mamba2-2.7b"])
def test_concrete_batch_structure_and_seed(arch):
    """The reference's structure, shapes and dtypes (its batch comes from
    jax.random; the port's from a CPU torch.Generator, ROADMAP C11); the
    same key gives the same batch, another key another."""
    cfg = configs.get(arch, reduced=True)
    jcfg = jconfigs.get(arch, reduced=True)
    spec = shapes.ShapeSpec("t", "train", 64 + cfg.n_frontend_tokens, 2)
    jspec = jshapes.ShapeSpec("t", "train", 64 + jcfg.n_frontend_tokens, 2)
    got = shapes.concrete_batch(cfg, spec, key=3)
    want = jshapes.concrete_batch(jcfg, jspec, key=3)
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "cpu"
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
    assert int(got["tokens"].min()) >= 0
    assert int(got["tokens"].max()) < cfg.vocab
    assert torch.all(got["mask"] == 1)
    again = shapes.concrete_batch(cfg, spec, key=3)
    other = shapes.concrete_batch(cfg, spec, key=4)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["tokens"], other["tokens"])
    if cfg.family not in ("vlm", "audio"):
        assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, 1))
    bf = shapes.concrete_batch(cfg, spec, key=3, dtype=torch.bfloat16)
    floats = [k for k in ("patches", "frames") if k in got]
    assert all(bf[k].dtype == torch.bfloat16 for k in floats)


def test_meta_mesh_refused_by_a_job():
    p = DepamParams(nfft=256, window_size=256, window_overlap=128,
                    record_size_sec=0.05)
    m = DatasetManifest(n_files=1, records_per_file=2,
                        record_size=p.record_size, fs=p.fs)
    job = api.job(m, p).on(meshlib.make_production_mesh())
    with pytest.raises(ValueError, match="dry run"):
        job.run()


@pytest.mark.parametrize("compress", [False, True])
def test_meta_mesh_refused_by_a_train_step_outside_a_meta_trace(compress):
    """A meta mesh is refused when the step is made: the dry run traces
    its step without one, and no step runs on it."""
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    with pytest.raises(ValueError, match="dry run"):
        trainstep.make_train_step(
            cfg, RunSpec(remat="none"), adamw.AdamWConfig(),
            compute_dtype=torch.float32,
            compress_pod_axis="pod" if compress else None,
            mesh=meshlib.make_production_mesh(multi_pod=True))
