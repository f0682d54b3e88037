"""Roofline terms of one NVIDIA H100, and the model's useful flops.

Three terms per (arch x shape x mesh), all in seconds:

  compute    = flops / PEAK_FLOPS[dtype]
  memory     = hbm_bytes / HBM_BW
  collective = wire_bytes / (LINK_BW * links_per_chip)

The counterpart of the reference's ``distributed/roofline.py``, with
the card's figures in place of the TPU's.  They come from NVIDIA's H100
SXM5 80GB data sheet at its 700 W limit: data-sheet peaks, not
measurements.  ``PEAK_FLOPS`` is keyed by the dtype a step computes in:
the port's float32 code and its seven kernels run on the CUDA cores (67
TFLOP/s); bf16 products run on the dense tensor cores (989 TFLOP/s).

The reference's ``parse_collectives`` and ``analyze_hlo`` are not here:
they parse XLA's compiled HLO text (its collectives and loop trip
counts).  Eager PyTorch has no partitioned program to parse, so the
port's dry run counts the whole program's flops and op bytes on
``meta`` tensors (``launch.dryrun``) and leaves the wire bytes unknown
(``None``).
"""
from __future__ import annotations

import torch

HBM_BW = 3.35e12           # bytes/s, HBM3
PEAK_FLOPS = {
    torch.float32: 67e12,      # CUDA cores, no tensor cores
    torch.bfloat16: 989e12,    # dense tensor cores
}
LINK_BW = 450e9            # bytes/s each way, NVLink 4 (900 GB/s both)


def roofline_terms_per_device(flops: float, hbm_bytes: float,
                              wire_bytes: float | None,
                              links_per_chip: float = 1.0,
                              dtype: torch.dtype = torch.bfloat16) -> dict:
    """Terms from per-device quantities.  ``wire_bytes=None`` (unknown)
    gives ``collective_s=None``; ``dominant`` and the bound are then
    taken over the two known terms."""
    compute_t = flops / PEAK_FLOPS[dtype]
    memory_t = hbm_bytes / HBM_BW
    coll_t = (None if wire_bytes is None
              else wire_bytes / (LINK_BW * links_per_chip))
    known = [("compute", compute_t), ("memory", memory_t)]
    if coll_t is not None:
        known.append(("collective", coll_t))
    dominant, bound = max(known, key=lambda kv: kv[1])
    return {"compute_s": compute_t, "memory_s": memory_t,
            "collective_s": coll_t, "dominant": dominant,
            "roofline_bound_s": bound,
            "compute_fraction_of_bound": compute_t / max(bound, 1e-30)}


def roofline_terms(flops: float, hbm_bytes: float,
                   wire_bytes: float | None, n_devices: int,
                   links_per_chip: float = 1.0,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """Terms from whole-program quantities, spread evenly over
    ``n_devices`` (``wire_bytes`` summed over every device)."""
    n = max(n_devices, 1)
    return roofline_terms_per_device(
        flops / n, hbm_bytes / n,
        None if wire_bytes is None else wire_bytes / n, links_per_chip,
        dtype)


def model_flops(cfg, n_tokens: int, train: bool) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens.

    N counts forward-active parameters (excluding embeddings' gather);
    factor 6 = fwd 2 + bwd 4; serving uses factor 2.  The model layer
    is imported here, so that the kernels' cost model
    (``kernels.roofline``) reads this module's constants without it."""
    from repro_torch.configs.base import RunSpec
    from repro_torch.models import lm
    from repro_torch.models.module import count_params

    total = count_params(lm.param_defs(cfg, RunSpec(tp=1)))
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_active = total - emb
    if cfg.n_experts:
        # experts contribute top_k/E of their weight count per token
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        n_active = n_active - expert \
            + expert * cfg.moe_top_k / cfg.n_experts
    factor = 6.0 if train else 2.0
    return factor * n_active * n_tokens
