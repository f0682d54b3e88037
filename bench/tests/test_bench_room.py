"""Room for a second cell: in a copy of ``bench/`` and ``BENCHMARK.json``,
a cell added by new files and appended entries alone -- the live driver
at one record a step, with its mix, tiny sizes, limits and one span
metric -- passes the rehearsal suite and the fault suite, and reads its
span metric in a tiny traced window.  No file that was there changes."""
import json
import os
import shutil
import subprocess
import sys

import bench_tiny

CELL, MIX, METRIC = "set1.live1", "live1", "step.ready_to_sink_ms_p95.live1"


def _add_cell(root):
    bench = root / "bench"
    mix = json.loads((bench / "mixes" / "live.json").read_text())
    mix.update(about="the live feed at one record a step", chunk=1,
               arrivals=[{"seconds": 1.0, "rate_per_s": 20}])
    (bench / "mixes" / f"{MIX}.json").write_text(json.dumps(mix))
    shutil.copy(bench / "tests" / "tiny" / "mixes" / "live.json",
                bench / "tests" / "tiny" / "mixes" / f"{MIX}.json")
    shutil.copy(bench / "limits" / "set1.live.json",
                bench / "limits" / f"{CELL}.json")
    (bench / "metrics" / f"{METRIC}.py").write_text(
        "from harness import readers\n\n\n"
        "def read(win):\n"
        "    return readers.ready_to_sink_ms_p95(win)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": CELL, "config": "depam_set1",
                              "traffic": MIX, "chips": 1,
                              "why": "one record a step"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    spec["per_layer"].append({"name": METRIC, "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "driver", "moves": "record_p95_ms",
                              "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))


def _files(bench):
    return {p.relative_to(bench): p.read_bytes()
            for p in bench.rglob("*") if p.is_file()}


def test_a_second_cell_needs_added_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_tiny.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_tiny.BENCH.parent / "BENCHMARK.json", root)
    (root / "src").symlink_to(bench_tiny.BENCH.parent / "src")
    before = _files(root / "bench")
    _add_cell(root)
    after = _files(root / "bench")
    assert all(after[p] == b for p, b in before.items())
    assert len(after) == len(before) + 4

    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "bench/tests/test_bench_rehearsal.py",
         "bench/tests/test_bench_faults.py"],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:]
    code = ("import json, sys; sys.path.insert(0, 'bench/tests'); "
            "import bench_tiny; "
            f"print(json.dumps(bench_tiny.run({CELL!r}, traced=True)))")
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"][METRIC]["value"] > 0
    assert out["program_trace"]["dropped"] == 0
