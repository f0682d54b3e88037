"""The port's training gradients against the reference's at published
width: qwen1.5-0.5b (24 layers, d 1024, vocab 151 936), one batch of
``--batch`` x ``--seq`` tokens, the reference's own weights (its
``init`` with a crc32 per-leaf seed, as the CPU tests take them).

    PYTHONPATH=src python3 scripts/train_parity_full_width.py [--device cuda]

The reference runs ``jax.value_and_grad`` of its ``loss_fn`` on the CPU
(JAX_PLATFORMS=cpu), in float32 and in float64 (``reference_in_float64``
of tests/torch_lm_cases.py); the port runs ``train.step.value_and_grad``
on ``--device`` (the card by default) at both precisions.  Printed, per
precision: the loss and grad norm of each package and their relative
deviation, and the worst grad leaf's deviation relative to its largest
magnitude.  The card's name and power limit come first.  Nothing is
gated: the tests hold the reduced configs; this reads how far the full
width carries the same agreement.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (a quick run on the CPU)")
    a = ap.parse_args(argv)
    import numpy as np
    import torch

    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro_torch.configs as configs
    import torch_lm_cases as T
    from repro_torch.models import lm, module
    from repro_torch.train import step as tstep

    if torch.device(a.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
    jcfg = jconfigs.get(a.arch, reduced=a.reduced)
    cfg = configs.get(a.arch, reduced=a.reduced)
    jrt, rt = T.rt_pair(remat="block")
    t0 = time.perf_counter()
    arrays = T.reference_params(jcfg, jrt)
    batch = T.make_batch(cfg, b=a.batch, s=a.seq)

    class Case:
        pass

    case = Case()
    case.jcfg, case.jrt, case.cfg, case.rt = jcfg, jrt, cfg, rt
    params = module.from_numpy(lm.param_defs(cfg, rt), arrays, a.device)
    print(f"{a.arch}: {module.count_params(lm.param_defs(cfg, rt)) / 1e9:.3f}"
          f" B params, {a.batch} x {a.seq} tokens; weights in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ("float32", "float64"):
        t0 = time.perf_counter()
        if name == "float64":
            with T.reference_in_float64():
                want = T.reference_loss_grads(case, T.tree64(arrays),
                                              T.batch64(batch))
            got = T.port_loss_grads(case, T.to64(params), T.batch64(batch),
                                    torch.float64)
        else:
            want = T.reference_loss_grads(case, arrays, batch)
            got = T.port_loss_grads(case, params, batch, torch.float32)
        gn = [float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                                for g in d.values())))
              for d in (want[1], {k: v.double().cpu().numpy()
                                  for k, v in got[1].items()})]
        errs = T.leaf_errors({k: v.double().cpu().numpy()
                              for k, v in got[1].items()}, want[1])
        worst = max(errs, key=errs.get)
        print(f"{name}: loss reference {float(want[0]):.10g} port "
              f"{float(got[0]):.10g} ({T.rel_err(float(got[0]), float(want[0])):.3e}"
              f" relative); grad norm reference {gn[0]:.6e} port {gn[1]:.6e} "
              f"({abs(gn[1] - gn[0]) / gn[0]:.3e}); worst grad leaf {worst} "
              f"{errs[worst]:.3e} of its largest magnitude "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del jax, jnp
    return 0


if __name__ == "__main__":
    sys.exit(main())
