"""Tiny sizes of every cell, for rehearsals of the harness on the CPU:
the same code, records of a few frames, a short manifest.

``run(cell)`` runs a cell of ``BENCHMARK.json`` by name at its tiny
size."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

SEED = 2 ** 31 + 11          # wider than 32 signed bits, as a run's may be

TINY = dict(record_size_sec=0.0625, file_sec=0.5, n_files=24,
            distinct_records=8)
MIX = {
    "live": dict(warmup_steps=2, arrivals=[{"seconds": 1.0,
                                            "rate_per_s": 200}],
                 check={"records": 4}),
}


def run(cell: str, traced: bool = False, seconds: float = 0.5,
        seed: int = SEED, extra: dict | None = None, **kw) -> dict:
    """One tiny window on the CPU; ``extra`` replaces further entries of
    the configuration or mix."""
    from harness import discover, runner
    mix_name = discover.cell(discover.benchmark(), cell)["traffic"]
    over = dict(TINY)
    over.update(MIX[mix_name])
    over.update(extra or {})
    return runner.run(cell, seed, seconds, traced, device="cpu",
                      overrides=over, **kw)
