"""End to end on the PyTorch/CUDA port: DEPAM features -> train the
seamless audio backbone.

    PYTHONPATH=src python examples/torch_train_audio_lm.py [--steps 200] \\
        [--big] [--ckpt-dir DIR] [--device cpu]

The integration the paper envisions ("PAM metrics processed
conjointly... learning representations of soundscapes"): the DEPAM
pipeline produces per-frame spectral features from raw audio; those
features ARE the modality-frontend input of the seamless-m4t backbone,
which is trained to predict pseudo-label token streams.  Everything runs
through the port's production code paths: the frame-PSD kernel (K5,
hand-written CUDA on the card), train_step with AdamW and gradient
accumulation, async checkpointing with resume.

Default scale is CPU-friendly (a few M params); ``--big`` switches to a
~100M-param backbone.  Runs on the card by default; ``--device cpu``
runs the plain PyTorch path.  The records and the batch of each step
are drawn from a generator seeded by the step, so a resumed run sees
the data an uninterrupted one sees.
"""
import argparse
import dataclasses
import time

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.api.sources import synth_record
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunSpec
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.kernels import ops as kernels
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep


def depam_frames(step, batch, n_frames, p, m, device):
    """Synthetic records -> per-frame PSD features via the DEPAM chain."""
    g = torch.Generator().manual_seed(step)
    idx = torch.randint(0, m.n_records, (batch,), generator=g)
    recs = torch.stack([synth_record(int(i), m, device) for i in idx])
    feats = kernels.frame_psd(recs, p)          # (B, frames, n_bins)
    feats = torch.log10(torch.clamp(feats, min=1e-12))
    mu = torch.mean(feats, dim=(1, 2), keepdim=True)
    sd = torch.std(feats, dim=(1, 2), keepdim=True, unbiased=False) + 1e-6
    return ((feats - mu) / sd)[:, :n_frames]


def run(steps=200, batch=4, frames=64, big=False, ckpt_dir=None,
        device="cuda", log_every=25, ckpt_every=50):
    """Train; returns the losses of the steps this call ran."""
    dev = resolve_device(device)
    cfg = configs.get("seamless-m4t-large-v2", reduced=True)
    if big:
        cfg = dataclasses.replace(cfg, n_layers=8, enc_layers=8,
                                  d_model=768, n_heads=12, n_kv_heads=12,
                                  head_dim=64, d_ff=3072, vocab=8192)
    # frontend consumes DEPAM PSD bins
    p = DepamParams(nfft=256, window_size=256, window_overlap=128,
                    record_size_sec=(frames + 1) * 128 / 32768.0)
    cfg = dataclasses.replace(cfg, frontend_dim=p.n_bins)
    m = DatasetManifest(n_files=64, records_per_file=4,
                        record_size=p.record_size, fs=p.fs, seed=5)

    rt = RunSpec(tp=1, remat="none", attn_chunk=256)
    opt = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=20,
                            total_steps=steps)
    defs = lm.param_defs(cfg, rt)
    print(f"[e2e] backbone {module.count_params(defs)/1e6:.1f}M params; "
          f"frontend = DEPAM PSD ({p.n_bins} bins/frame) on {dev}")

    state = trainstep.init_train_state(defs, opt, device=dev)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr:
        restored, rstep = mgr.restore(state)
        if restored is not None:
            state, start = restored, rstep
            print(f"[e2e] resumed at step {start}")

    fn = trainstep.make_train_step(cfg, rt, opt, compute_dtype=torch.float32)

    s_dec = frames // 4
    t0 = time.time()
    losses = []
    for step_i in range(start, steps):
        x = depam_frames(step_i, batch, frames, p, m, dev)
        # pseudo-labels: quantized band energies as a token stream
        toks = torch.clamp(
            (torch.mean(x.reshape(batch, s_dec, -1), dim=-1) * 8
             + 16).to(torch.int32), 0, cfg.vocab - 1)
        b = {"frames": x, "tokens": toks,
             "labels": torch.roll(toks, -1, dims=1),
             "mask": torch.ones_like(toks, dtype=torch.float32)}
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
        if step_i % log_every == 0 or step_i == steps - 1:
            print(f"  step {step_i:4d} loss={losses[-1]:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if mgr and (step_i + 1) % ckpt_every == 0:
            mgr.save(step_i + 1, state)
    if mgr:
        mgr.save(steps, state)
        mgr.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--big", action="store_true",
                    help="~100M-param backbone")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; exits without a CUDA "
                         "device) or 'cpu'")
    a = ap.parse_args(argv)
    try:
        resolve_device(a.device)
    except (RuntimeError, ValueError) as e:
        ap.error(f"--device {a.device}: {e}; pass --device cpu to train "
                 f"on the CPU")
    losses = run(a.steps, a.batch, a.frames, a.big, a.ckpt_dir, a.device)
    print(f"[e2e] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    assert losses[-1] < losses[0], "training did not reduce the loss"


if __name__ == "__main__":
    main()
