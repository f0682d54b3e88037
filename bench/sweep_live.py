"""The knee of a live cell: the highest offered rate at which the ring's
backlog does not grow across the window.

    python3 bench/sweep_live.py --rates 80,100,120,140 --seconds 10 \\
        --seed 5

One process, one run of the cell per rate (the mix's arrivals replaced
by that fixed rate), on the card, in ascending order.  For each rate it
prints the record latency quantiles, the pusher's largest lateness, the
driving thread's ms a step by phase, and the mean backlog (records
pushed but not yet delivered) in the first and last quarter of the
window; a rate holds where the backlog grows by a record or less.  The
last line is one JSON object with every row and the knee: the highest
rate below which every rate held.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--workload", default="set1.live")
    a = ap.parse_args()
    import numpy as np

    from harness import runner

    rows, knee = [], None
    for i, rate in enumerate(sorted(float(r) for r in a.rates.split(","))):
        look: dict = {}
        t0 = time.perf_counter()
        out = runner.run(a.workload, a.seed + i, a.seconds, False,
                         overrides={"arrivals": [{"seconds": 1.0,
                                                  "rate_per_s": rate}]},
                         inspect=look)
        win = look["window"]
        lat = win.extra["latency_s"] * 1e3
        bl = np.asarray(win.extra["backlog"])
        t = bl[:, 0] / a.seconds
        row = {"rate": rate, "correct": out["correct"],
               "p50_ms": float(np.quantile(lat, 0.5)),
               "p95_ms": float(np.quantile(lat, 0.95)),
               "max_ms": float(lat.max()),
               "late_max_ms": float(win.extra["late_s"].max() * 1e3),
               "host_ms_per_step": {k: v / max(win.steps, 1) * 1e3
                                    for k, v in win.host.items()},
               "backlog_first_q": float(bl[t < 0.25, 1].mean()),
               "backlog_last_q": float(bl[t >= 0.75, 1].mean()),
               "run_s": time.perf_counter() - t0}
        row["held"] = bool(row["backlog_last_q"] - row["backlog_first_q"]
                           <= 1.0 and np.isfinite(row["p95_ms"]))
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["held"]:
            break
        knee = rate
    print(json.dumps({"workload": a.workload, "seconds": a.seconds,
                      "card": runner.card_limit(), "knee": knee,
                      "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
