"""Interchange with state the reference package committed.

DEPAM has no weights: its state is the feature store's committed
cursor plus the reduction carry.  The port's ``core.store`` reads the
reference's on-disk layout unchanged and its carry keys keep the
reference's names (``__r:<window>:<out>:<field>``, ``:c`` Kahan
companions, ``__live__``), so a store the reference committed mid-job
resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch


def carry_from_reference(agg: dict[str, np.ndarray], live,
                         device: str | torch.device
                         ) -> dict[str, torch.Tensor]:
    """A committed carry (``FeatureStore.load_agg``'s arrays, float64
    widenings of float32/int32 state) -> tensors on ``device``, plus
    ``__live__`` as an int32 scalar.  Values stay float64 here; the
    engine casts each to its field's dtype, which is exact because every
    value started life as a float32 or int32."""
    out = {name: torch.as_tensor(np.asarray(v), device=device)
           for name, v in agg.items()}
    out["__live__"] = torch.tensor(int(live), dtype=torch.int32,
                                   device=device)
    return out
