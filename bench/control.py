"""Readings behind the limits of a cell's checks, on the card.

    python3 bench/control.py --workload set1.live --seeds 11,12,13 \\
        --seconds 3

For each seed, one run of the cell at its own size and load (a short
window), in one process: the program's numbers, and on the same sample
the control's -- the reference in TF32 put in the program's place (the
reduction stage kept in bfloat16).  The lower reading of a number is the
largest the program gives over the seeds, the upper the smallest the
control gives; the last line is one JSON object with both, per number.
"""
import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args()
    from harness import runner

    program, control = {}, {}
    for seed in (int(s) for s in a.seeds.split(",")):
        look = {"control": True}
        out = runner.run(a.workload, seed, a.seconds, False, inspect=look)
        got = {k: v["value"] for k, v in out["checks"].items()}
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": got, "control": look["control"]}),
              flush=True)
        for k, v in got.items():
            program.setdefault(k, []).append(v)
        for k, v in look["control"].items():
            control.setdefault(k, []).append(v)
    print(json.dumps({"workload": a.workload, "readings": {
        k: {"lower": max(program[k]), "upper": min(control[k]),
            "program": program[k], "control": control[k]}
        for k in program}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
