"""Interchange with state the reference package committed.

DEPAM has no weights: its state is the feature store's committed
cursor plus the reduction carry.  The port's ``core.store`` reads the
reference's on-disk layout unchanged and its carry keys keep the
reference's names (``__r:<window>:<out>:<field>``, ``:c`` Kahan
companions), so a store the reference committed mid-job
resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch


def carry_from_reference(agg: dict[str, np.ndarray],
                         device: str | torch.device
                         ) -> dict[str, torch.Tensor]:
    """A committed carry (``FeatureStore.load_agg``'s arrays, float64
    widenings of float32/int32 state) -> tensors on ``device``; the
    committed live count stays on the host.  Values stay float64 here; the
    engine casts each to its field's dtype, which is exact because every
    value started life as a float32 or int32."""
    return {name: torch.as_tensor(np.asarray(v), device=device)
            for name, v in agg.items()}
