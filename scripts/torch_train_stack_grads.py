"""How the layer loop takes each layer's weights from the stacked
leaves, timed in a training step: ``torch.unbind`` once per call (the
port's ``models.blocks.layers``: one stacked grad per leaf in the
backward) against ``a[i]`` per layer (``blocks.layer``: each select's
backward builds a zero-filled grad the size of the whole stack, and
autograd sums the per-layer ones).

    python3 scripts/torch_train_stack_grads.py [--steps 6] [--arch ...]

On one CUDA GPU: qwen1.5-0.5b at published width, chip_smoke.py phase
12a's batch and step (f32, TF32 off, remat per block), the two routes in
turns (unbind, select, select, unbind), each route's step ms (median
after a warm-up) and peak device memory (the state and one step's
output live on the card, earlier results on the host), and whether the
two routes give the same bits.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this script measures on a CUDA GPU")
    import chip_smoke as cs
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import blocks, module
    from repro_torch.train import step as trainstep

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rt, opt, defs, fn = cs.train_setup(a.steps)
    batch = synth_batch(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, 0, "cuda")
    state = trainstep.init_train_state(defs, opt, device="cuda",
                                       generator=cs.SEED)
    unbind = blocks.layers

    def select(tree):
        n = module.leaves_with_path(tree)[0][1].shape[0]
        return [blocks.layer(tree, i) for i in range(n)]

    results = {}
    for name, route in (("unbind", unbind), ("select", select),
                        ("select", select), ("unbind", unbind)):
        blocks.layers = route
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(a.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = fn(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        results.setdefault(name, []).append(
            (statistics.median(secs[1:]) * 1e3,
             torch.cuda.max_memory_allocated() / 2**30,
             module.tree_map(lambda t: t.cpu(), new["opt"]["master"])))
        del new, m
    blocks.layers = unbind
    same = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        module.leaves_with_path(results["unbind"][0][2]),
        module.leaves_with_path(results["select"][0][2])))
    for name, runs in results.items():
        print(f"{name}: step ms {[round(r[0], 2) for r in runs]}, peak GiB "
              f"{[round(r[1], 3) for r in runs]}")
    print(f"same master bits after one step: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
