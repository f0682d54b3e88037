"""The port's sharded execution: partition plans against the
reference's, the placement helpers and host meshes, ``rows=`` streaming,
the job's ``.shards``/``.on``, and the executor-count matrix of the
reference's ``tests/test_partition.py`` — D in {1, 2, 4} executors x
{fresh, resumed across D} x {float32, int16} x {sync, async}, on
``["cpu"] * D`` meshes: every run bitwise equal to the no-mesh
``.shards(4)`` run, dense, windowed, epoch and event outputs included.
The port's ``.shards(4)`` is held against the reference's within the
reference's tolerances, with event onset, duration and peak bin exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import PARAM_SET_1 as JSET1
from repro.data import wavio as jwavio
from repro.distributed import partition as jpartition
from repro_torch import api
from repro_torch.core import pipeline
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PARAM_SET_1
from repro_torch.core.store import FeatureStore
from repro_torch.distributed import partition
from repro_torch.launch.mesh import (data_axes, data_size, device_mesh,
                                     make_host_mesh)

P = dataclasses.replace(PARAM_SET_1, record_size_sec=0.5)
JP = dataclasses.replace(JSET1, record_size_sec=0.5)
FILES = (3, 6, 3, 4, 4)
M = DatasetManifest.from_files(FILES, record_size=P.record_size, fs=P.fs,
                               seed=3)
JM = JManifest.from_files(FILES, record_size=JP.record_size, fs=JP.fs,
                          seed=3)
FEATS = ("welch", "spl", "tol", "percentiles", "ltsa", "spd", "minmax")
# frame SPL of write_dataset's noise (0.05 full scale) is about -26 dB
THRESHOLD_DB, HYSTERESIS_DB = -25.5, 0.5
L = 4


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    jwavio.write_dataset(root, JM)
    return root


def port_job(wavs, *, d=None, payload="float32", mode="sync", store=None,
             limit=None, kernels=False):
    j = (api.job(M, P).features(*FEATS).window(records=3).chunk(2)
         .kernels(kernels).shards(L).source(api.WavSource(wavs))
         .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB, impulsive=True)
         .payload(payload).limit(limit))
    j = j.device("cpu") if d is None else j.on(device_mesh(["cpu"] * d))
    if mode == "async":
        j = j.async_io()
    return j if store is None else j.to(FeatureStore(store))


def assert_bitwise(a, b, tag):
    assert sorted(a.features) == sorted(b.features), tag
    for k in a.features:
        assert np.array_equal(a.features[k], b.features[k]), (tag, k)
    for k in a.windows:
        assert np.array_equal(a.windows[k], b.windows[k],
                              equal_nan=True), (tag, k)
    for k in a.epoch:
        assert np.array_equal(a.epoch[k], b.epoch[k]), (tag, k)
    assert sorted(a.events) == sorted(b.events), tag
    for k in a.events:
        assert np.array_equal(a.events[k].counts, b.events[k].counts), \
            (tag, k)
        assert np.array_equal(a.events[k].rows, b.events[k].rows), (tag, k)
    assert a.n_records == b.n_records


_NO_MESH: dict = {}


def no_mesh(wavs, payload):
    if payload not in _NO_MESH:
        _NO_MESH[payload] = port_job(wavs, payload=payload).run()
    return _NO_MESH[payload]


# -- plans, placement, meshes --------------------------------------------

@pytest.mark.parametrize("files,n_shards,chunk", [
    ((3, 6, 3, 4, 4), 4, 2), ((100,), 4, 8), ((5, 0, 7, 1), 3, 3),
    ((2, 2, 2, 2, 2, 2), 8, 1)])
def test_partition_plan_matches_reference(files, n_shards, chunk):
    m = DatasetManifest.from_files(files, record_size=64, fs=100.0, seed=7)
    jm = JManifest.from_files(files, record_size=64, fs=100.0, seed=7)
    a = partition.build_partition(m, n_shards, chunk)
    b = jpartition.build_partition(jm, n_shards, chunk)
    assert a.offsets == b.offsets and a.n_steps == b.n_steps
    for step in range(a.n_steps):
        assert np.array_equal(a.step_indices(step), b.step_indices(step))
        assert np.array_equal(a.step_mask(step), b.step_mask(step))
        assert a.cursor_after(step) == b.cursor_after(step)
    assert np.array_equal(a.record_order(), b.record_order())


def test_shard_sharding_orders_executors_by_data_coordinate():
    mesh = device_mesh(["cpu"] * 4)
    assert mesh.shape == {"data": 4, "model": 1}
    assert data_axes(mesh) == ("data",) and data_size(mesh) == 4
    assert partition.data_parallel_size(mesh, ("data",)) == 4
    assert partition.shard_sharding(mesh, ("data",)) == \
        (torch.device("cpu"),) * 4
    grid = device_mesh(["cuda:0", "cuda:1", "cuda:2", "cuda:3"], model=2)
    assert grid.shape == {"data": 2, "model": 2}
    # the model axis is replicated: one executor per data coordinate
    assert partition.shard_sharding(grid, ("data",)) == (
        torch.device("cuda:0"), torch.device("cuda:2"))
    assert partition.shard_sharding(grid, ("data", "model")) == tuple(
        torch.device(f"cuda:{i}") for i in range(4))
    with pytest.raises(ValueError, match="not axes of the mesh"):
        partition.shard_sharding(mesh, ("pod",))


def test_split_rows_hands_each_executor_its_rows():
    x = np.arange(4 * 2 * 3).reshape(4, 2, 3)
    blocks = partition.split_rows(x, 2)
    assert [b.shape for b in blocks] == [(2, 2, 3), (2, 2, 3)]
    assert np.array_equal(np.concatenate(blocks), x)
    assert np.shares_memory(blocks[1], x)
    with pytest.raises(ValueError, match="evenly"):
        partition.split_rows(x, 3)


def test_device_mesh_refusals():
    with pytest.raises(ValueError, match="positive multiple"):
        device_mesh(["cpu"] * 3, model=2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        device_mesh(["cpu", "cuda:0"])


def test_make_host_mesh_oversubscribed_names_requested_shape():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError) as ei:
        make_host_mesh(data=n + 1)
    assert f"data={n + 1}" in str(ei.value)
    assert "model=1" in str(ei.value)


@pytest.mark.parametrize("prefetch", [False, True])
def test_rows_slice_streams_rows_of_the_full_stream(wavs, prefetch):
    """``stream(rows=slice(a, b))`` equals rows a:b of the full stream,
    for the plain source and the prefetching one."""
    pl_ = partition.build_partition(M, L, 2)
    src = api.WavSource(wavs)
    if prefetch:
        src = api.PrefetchSource(src, depth=2)
    src = src.bind(M, P)
    full = list(src.stream(pl_, 0, pl_.n_steps))
    part = list(src.stream(pl_, 1, pl_.n_steps, rows=slice(1, 3)))
    src.close()
    assert len(part) == pl_.n_steps - 1
    for got, want in zip(part, full[1:]):
        assert got.shape == (2, 2, P.record_size)
        assert np.array_equal(got, want[1:3])


# -- the job's setters ---------------------------------------------------

def test_plan_choice():
    j = api.job(M, P).chunk(2).device("cpu")
    assert type(j._plan()).__name__ == "ShardPlan"
    assert isinstance(j.shards(L)._plan(), partition.PartitionPlan)
    assert j._plan().n_shards == L
    on2 = api.job(M, P).chunk(2).on(device_mesh(["cpu"] * 2))
    assert on2._plan().n_shards == 2            # default: one per executor
    assert api.job(M, P).on(device_mesh(["cpu"]))._plan().n_shards == 1


def test_sharding_refusals():
    with pytest.raises(ValueError, match="shards must be >= 1"):
        api.job(M, P).shards(0)
    with pytest.raises(ValueError, match="not divisible"):
        api.job(M, P).shards(3).on(device_mesh(["cpu"] * 2))._plan()
    # no fallback between device kinds, either way round
    with pytest.raises(ValueError, match=r"\.device\('cpu'\) conflicts"):
        (api.job(M, P).shards(2).device("cpu")
         .on(device_mesh(["cuda:0"] * 2)))._plan()
    with pytest.raises(ValueError, match=r"\.device\('cuda'\) conflicts"):
        (api.job(M, P).shards(2).device("cuda")
         .on(device_mesh(["cpu"] * 2)))._plan()


def test_committed_plan_must_divide_over_the_executors(wavs, tmp_path):
    """A store committed under .shards(4) resumes at any D dividing 4,
    and refuses a D that does not, naming the counts."""
    d = str(tmp_path / "s")
    port_job(wavs, d=4, store=d, limit=1).run()
    j = (api.job(M, P).features(*FEATS).window(records=3).chunk(2)
         .kernels(False).source(api.WavSource(wavs))
         .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB, impulsive=True)
         .on(device_mesh(["cpu"] * 3)).to(FeatureStore(d)))
    with pytest.raises(ValueError, match="4 logical shard.*3 data-parallel"):
        j.run()


# -- the executor-count matrix -------------------------------------------

@pytest.mark.parametrize("payload", ["float32", "int16"])
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_fresh_runs_bitwise_across_executor_counts(wavs, payload, mode, d):
    want = no_mesh(wavs, payload)
    assert want.events["events"].n_events > 0
    assert_bitwise(port_job(wavs, d=d, payload=payload, mode=mode).run(),
                   want, f"fresh {payload} {mode} D={d}")


@pytest.mark.parametrize("payload", ["float32", "int16"])
@pytest.mark.parametrize("first,second", [("sync", "sync"),
                                          ("async", "sync"),
                                          ("sync", "async")])
def test_resumed_across_executor_counts_bitwise(wavs, tmp_path, payload,
                                                first, second):
    """2 steps committed at D=4, finished at D=2 (and the other way):
    bitwise equal to the fresh no-mesh run."""
    d = str(tmp_path / "s")
    port_job(wavs, d=4, payload=payload, mode=first, store=d,
             limit=2).run()
    j = port_job(wavs, d=2, payload=payload, mode=second, store=d)
    assert j.resume_step() == 2
    assert_bitwise(j.run(), no_mesh(wavs, payload),
                   f"resumed {payload} {first}->{second}")


def test_int16_equals_float32_when_sharded(wavs):
    assert_bitwise(no_mesh(wavs, "int16"), no_mesh(wavs, "float32"),
                   "int16 vs float32")


def test_kernel_path_bitwise_across_executor_counts(wavs):
    """The kernel wrappers' plain versions (``.kernels(True)`` on the
    CPU) keep the invariant too."""
    want = port_job(wavs, kernels=True).run()
    assert_bitwise(port_job(wavs, d=4, kernels=True).run(), want, "kernels")


def test_run_pipeline_over_a_mesh():
    got = pipeline.run_pipeline(M, P, mesh=device_mesh(["cpu"] * 2),
                                chunk_records=2)
    want = (api.job(M, P).features("welch", "spl", "tol").chunk(2)
            .shards(2).device("cpu").run())
    for k in ("welch", "spl", "tol"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["mean_welch"], want["mean_welch"])
    assert got["plan"].n_shards == 2


# -- against the reference -----------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded(wavs):
    return (japi.job(JM, JP).features(*FEATS).window(records=3).chunk(2)
            .kernels(False).shards(L).source(japi.WavSource(wavs))
            .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                    impulsive=True).run())


def assert_close_to_reference(got, want):
    """The reference's tolerances (tests/test_kernels.py): 1e-4 relative
    for the linear Welch outputs, 1e-3 dB for levels; event onset,
    duration and peak bin exact, in record order."""
    for k in ("welch", "ltsa", "mean_welch", "min_welch", "max_welch"):
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                          np.float64)
        assert np.max(np.abs(g - w) / np.abs(w)) < 1e-4, k
    for k in ("spl", "tol", "percentiles"):
        assert np.max(np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(want[k], np.float64))) < 1e-3, k
    assert np.max(np.abs(got["spd"] - np.asarray(want["spd"]))) < 1e-2
    ge, we = got.events["events"], want.events["events"]
    assert np.array_equal(ge.counts, np.asarray(we.counts))
    wr = np.asarray(we.rows)
    assert np.array_equal(ge.rows[:, :3], wr[:, :3])
    assert np.max(np.abs(ge.rows[:, 3] - wr[:, 3])) < 1e-3


@pytest.mark.parametrize("kernels", [False, True])
def test_sharded_job_matches_reference(wavs, jax_sharded, kernels):
    got = port_job(wavs, kernels=kernels).run()
    assert got.plan.offsets == jax_sharded.plan.offsets
    assert got.events["events"].n_events > 0
    assert_close_to_reference(got, jax_sharded)


def test_sharded_over_executors_matches_reference(wavs, jax_sharded):
    assert_close_to_reference(port_job(wavs, d=2).run(), jax_sharded)


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
def test_executors_on_card_bitwise_unsharded_mesh(wavs, cuda, d):
    """D executors over one card, repeated, through the CUDA kernels:
    bitwise equal to the no-mesh ``.shards(4)`` job on the card."""
    def job(mesh):
        j = (api.job(M, P).features(*FEATS).window(records=3).chunk(2)
             .shards(L).source(api.WavSource(wavs))
             .events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                     impulsive=True))
        return j.device(cuda) if mesh is None else j.on(mesh)

    want = job(None).run()
    assert_bitwise(job(device_mesh([cuda] * d)).run(), want, f"card D={d}")
