"""Device resolution: the port runs on the card unless told otherwise.

There is no silent CPU fallback.  Asking for ``"cuda"`` on a machine
without a CUDA device raises, naming the explicit opt-in
(``.device("cpu")``), so a run never reports CPU numbers as if they
came from the card.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` / a ``torch.device`` ->
    ``torch.device``; raises RuntimeError when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default and never falls back to the CPU silently — pass "
            ".device('cpu') to the job builder (or device='cpu') to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"unsupported device {dev}; use 'cpu' or 'cuda'"
            + (" (a meta device holds shapes only, for the dry run: "
               "python -m repro_torch.launch.dryrun)"
               if dev.type == "meta" else ""))
    return dev
