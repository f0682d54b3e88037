"""The training loop: data pipeline -> train_step -> checkpoints.

Runs at smoke scale on the CPU (``--device cpu``) and at published
width on the card (the default; without a CUDA device it exits naming
``--device cpu``).  Fault tolerance: CheckpointManager commits the
state, whose step is the data cursor, atomically; on restart the loop
resumes from LATEST at that step.  The synthetic token stream is a pure
function of the global step (lineage), so recovery is exact.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
      [--device cpu]

``synth_batch`` draws from a CPU ``torch.Generator`` seeded from the
step, then moves the batch to the device, so a step's batch is the same
on every device.  It is not the reference's stream (``jax.random``
bits cannot be drawn without jax); parity checks feed both packages the
same numpy batches.
"""
from __future__ import annotations

import argparse
import time

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep

DATA_SEED = 1234


def synth_batch(cfg, batch: int, seq: int, step: int, device="cuda"):
    """Deterministic token stream keyed by global step (lineage)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(module.leaf_seed(DATA_SEED,
                                                       f"step/{step}"))
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=g)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1),
           "mask": torch.ones((batch, seq), dtype=torch.float32)}
    if cfg.family == "vlm":
        out["patches"] = torch.randn(
            (batch, cfg.n_frontend_tokens, cfg.frontend_dim), generator=g)
    if cfg.family == "audio":
        out["frames"] = torch.randn((batch, seq * 4, cfg.frontend_dim),
                                    generator=g)
    return {k: v.to(dev) for k, v in out.items()}


def run(arch: str, reduced: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str | None, ckpt_every: int = 20, lr: float = 3e-3,
        microbatches: int = 1, log_every: int = 10, device="cuda"):
    dev = resolve_device(device)
    cfg = configs.get(arch, reduced=reduced)
    rt = RunSpec(tp=1, remat="block", microbatches=microbatches,
                 attn_chunk=512)
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 10, 5),
                                total_steps=steps)
    defs = lm.param_defs(cfg, rt)
    print(f"[train] {cfg.name}: {module.count_params(defs)/1e6:.1f}M params "
          f"on {dev}")

    state = trainstep.init_train_state(defs, opt_cfg, device=dev)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, rstep = mgr.restore(state)
        if restored is not None:
            state, start = restored, rstep
            print(f"[train] resumed from step {start}")

    fn = trainstep.make_train_step(cfg, rt, opt_cfg,
                                   compute_dtype=torch.float32)
    losses = []
    t0 = time.time()
    for step_i in range(start, steps):
        b = synth_batch(cfg, batch, seq, step_i, dev)
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
        if step_i % log_every == 0 or step_i == steps - 1:
            dt = time.time() - t0
            print(f"  step {step_i:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if mgr is not None and (step_i + 1) % ckpt_every == 0:
            mgr.save(step_i + 1, state)
    if mgr is not None:
        mgr.save(steps, state)
        mgr.wait()
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; exits without a CUDA "
                         "device) or 'cpu'")
    a = ap.parse_args(argv)
    try:
        resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}; pass --device cpu to train on "
                 f"the CPU")
    losses = run(a.arch, a.reduced, a.steps, a.batch, a.seq, a.ckpt_dir,
                 microbatches=a.microbatches, lr=a.lr, device=a.device)
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        print("[train] nothing to do: the checkpoint is at the last step")


if __name__ == "__main__":
    main()
