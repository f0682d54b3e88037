"""Find a cell's parts by the names in ``BENCHMARK.json``.

  * ``configs[].file``          the deployment's sizes (JSON);
  * ``mixes/<traffic>.json``     the traffic mix: parameters only, among
                                 them ``driver``, the name of the code
                                 that feeds the program;
  * ``drivers/<driver>.py``      how records reach the program and the
                                 results leave it: a ``build(ctx)`` that
                                 returns the cell's job with its
                                 ``warm``, ``window``, ``finish`` and
                                 ``check`` hooks (``drivers/live.py``);
  * ``limits/<workload>.json``   the limits of the cell's checks;
  * ``metrics/<metric>.py``      one reader per per-layer metric, a
                                 ``read(window)`` function;
  * ``costs/<function>.py``      the frozen cost of one kernel function
                                 of ``repro_torch.kernels.ops``, a
                                 ``cost(p, args, kwargs)`` function;
  * ``tests/tiny/configs/<config>.json``, ``tests/tiny/mixes/<traffic>.json``
                                 the tiny sizes of the CPU rehearsals
                                 (``tests/bench_tiny.py``).

Adding a configuration, a mix, a driver, a cell, a metric or a kernel
cost adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str) -> dict:
    with open(BENCH / "mixes" / f"{traffic}.json") as f:
        return json.load(f)


def limits(workload: str) -> dict:
    with open(BENCH / "limits" / f"{workload}.json") as f:
        return json.load(f)


def metrics_of(spec: dict, workload: str, kind: str) -> list[dict]:
    """The cell's metrics of one kind (``end_to_end``/``per_layer``):
    those that list it, or list no cells."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def _module(folder: str, name: str):
    path = BENCH / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    """The module ``drivers/<name>.py``."""
    return _module("drivers", name)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def costs() -> dict:
    """Kernel function name -> the ``cost`` function of
    ``costs/<name>.py``, for every file there."""
    return {p.stem: _module("costs", p.stem).cost
            for p in sorted((BENCH / "costs").glob("*.py"))}
