"""The harness end to end on the CPU at tiny sizes: discovery of every
cell's files by name, one window per cell with tracing off and on, the
result line's keys, and that nothing the run loads is JAX or the JAX
package.  Device metrics are absent here: none is made up from the CPU.
The same run on a card is ``test_card_run``, marked ``cuda``."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import bench_tiny
from harness import discover, runner
from repro_torch.kernels import ops

SPEC = discover.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        kinds = [m for m in SPEC["end_to_end"]
                 if w["name"] in m.get("workloads", CELLS)]
        assert len(kinds) >= 2
        assert discover.metrics_of(SPEC, w["name"], "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_is_found_by_name(cell):
    w = discover.cell(SPEC, cell)
    discover.config(SPEC, w["config"])
    mix = discover.mix(w["traffic"])
    assert callable(discover.driver(mix["driver"]).build)
    assert discover.limits(cell)
    assert bench_tiny.sizes(cell)
    files = {p.stem for p in (bench_tiny.BENCH / "costs").glob("*.py")}
    assert set(discover.costs()) == files
    for name in files:
        assert callable(getattr(ops, name)), name
    for m in discover.metrics_of(SPEC, cell, "per_layer"):
        assert callable(discover.reader(m["name"]))


def _keys(out, traced, cell):
    """The result line's keys, and each metric of the cell exactly where
    ``metrics_of`` lists it: every one but those read from the device,
    which no CPU run makes up."""
    assert list(out)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(out)[-1] == "checks"
    assert "device" not in out and "breakdown" not in out
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in discover.metrics_of(SPEC, cell, kind)
            if m["source"] != "device_trace"}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert not any(n.endswith("_roofline") or "roofline." in n
                   for n in out["metrics"])
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_window(name):
    out = bench_tiny.run(name)
    _keys(out, False, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"]
    assert "program_trace" not in out
    assert runner.leaked_modules() == []


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_window(name):
    out = bench_tiny.run(name, traced=True)
    _keys(out, True, name)
    assert out["correct"], out["checks"]
    assert list(out)[-2] == "program_trace"
    assert out["program_trace"]["dropped"] == 0


def test_arrivals_follow_the_mix_alone():
    """A fixed rate is one phase; on/off bursts are phases cycled."""
    from harness import arrivals
    due = arrivals.schedule([{"seconds": 1.0, "rate_per_s": 70}], 30.0)
    assert len(due) == 2100 and np.allclose(np.diff(due), 1 / 70)
    burst = arrivals.schedule([{"seconds": 1.0, "rate_per_s": 140},
                               {"seconds": 3.0, "rate_per_s": 70 / 3}],
                              8.0)
    assert np.all(np.diff(due) > 0)
    assert len(burst) == 2 * (140 + 70)
    assert np.count_nonzero(burst < 1.0) == 140
    assert np.count_nonzero((burst >= 4.0) & (burst < 5.0)) == 140


def test_run_py_refuses_without_a_card():
    """bench/run.py itself exits non-zero and prints no result where
    torch sees no card (this box), and loads no JAX on the way."""
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(bench_tiny.BENCH / "run.py"),
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=str(bench_tiny.BENCH.parent))
    if r.returncode == 0:
        pytest.skip("a CUDA card is present; test_card_run covers it")
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_a_run_loads_no_jax_in_a_fresh_process():
    code = (
        "import sys; sys.path.insert(0, {t!r}); import bench_tiny; "
        "bench_tiny.run('set1.live'); "
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
    ).format(t=str(bench_tiny.BENCH / "tests"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=""),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_harness_sources_import_no_jax():
    """A scan of the harness's own files besides the run above: no
    import of JAX, the JAX package, or the JAX package's benchmarks."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro|"
                     r"benchmarks)(\s|\.|$)", re.M)
    for path in bench_tiny.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not pat.search(path.read_text()), path


@pytest.mark.cuda
def test_card_run():
    """One short run of each cell through bench/run.py on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        r = subprocess.run([sys.executable,
                            str(bench_tiny.BENCH / "run.py"), "--workload",
                            cell, "--seed", "3", "--seconds", "2",
                            "--trace", "0"], capture_output=True, text=True,
                           cwd=str(bench_tiny.BENCH.parent), timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["correct"] and out["device"]["platform"] == "gpu"
