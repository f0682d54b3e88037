"""Benchmark of DEPAM's PyTorch/CUDA port (``src/repro_torch``): one run
of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload set1.live --seed 7 --seconds 30 \\
        --trace 0

Run from the root of a checkout, on a machine with a CUDA card.  The
last line of standard output is the run's result as one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last the ``checks``:
each number compared with its limit, also printed as the last lines of
standard error.

The program's kernel library and any other build or kernel cache go to
fixed directories under ``build/`` in the checkout, so that only a
checkout's first run builds.  The inputs are drawn from the seed in
memory; nothing else is written.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches() -> None:
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench/run.py: src/repro_torch is missing; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    _caches()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    import torch

    from harness import discover, runner

    cellspec = discover.cell(discover.benchmark(), a.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cellspec["chips"]:
        print(f"bench/run.py: {a.workload} needs {cellspec['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = runner.run(a.workload, a.seed, a.seconds, bool(a.trace),
                     device="cuda", t_process=T_PROCESS)
    leaked = runner.leaked_modules()
    if leaked:
        print(f"bench/run.py: the run loaded {leaked}; the port must run "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"window {json.dumps(out['window'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
