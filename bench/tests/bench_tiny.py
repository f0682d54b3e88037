"""Tiny sizes of every cell, for rehearsals of the harness on the CPU:
the same code, records of a few frames, a short manifest.

The sizes are data: ``tiny/configs/<config>.json`` replaces entries of a
configuration, ``tiny/mixes/<traffic>.json`` entries of a mix, each
found by the name ``BENCHMARK.json`` gives the cell's configuration and
traffic.  ``run(cell)`` runs a cell of ``BENCHMARK.json`` by name at its
tiny size."""
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
TINY = Path(__file__).resolve().parent / "tiny"
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

SEED = 2 ** 31 + 11          # wider than 32 signed bits, as a run's may be


def sizes(cell: str) -> dict:
    """The cell's tiny entries: its configuration's, then its mix's."""
    from harness import discover
    w = discover.cell(discover.benchmark(), cell)
    out = {}
    for folder, name in (("configs", w["config"]), ("mixes", w["traffic"])):
        with open(TINY / folder / f"{name}.json") as f:
            out.update(json.load(f))
    return out


def run(cell: str, traced: bool = False, seconds: float = 0.5,
        seed: int = SEED, extra: dict | None = None, **kw) -> dict:
    """One tiny window on the CPU; ``extra`` replaces further entries of
    the configuration or mix."""
    from harness import runner
    over = sizes(cell)
    over.update(extra or {})
    return runner.run(cell, seed, seconds, traced, device="cpu",
                      overrides=over, **kw)
