"""Legacy pipeline entry point — a thin shim over ``repro_torch.api``.

Keeps the reference's ``run_pipeline()`` return payload for existing
callers; new code should use::

    from repro_torch import api
    api.job(manifest, params).features("welch", "spl", "tol").run()

Sharding (``mesh``/``data_axes``) comes with the sharded slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.api import job
from .manifest import DatasetManifest
from .params import DepamParams


def run_pipeline(m: DatasetManifest, p: DepamParams,
                 chunk_records: int = 8, store=None, with_tol: bool = True,
                 use_kernels: bool = True,
                 reader: Callable[[np.ndarray], np.ndarray] | None = None,
                 max_steps: int | None = None,
                 device: str | torch.device = "cuda"):
    """Drive the full DEPAM job; resumable via ``store`` (feature store).

    reader: optional host function global_indices((n_shards, chunk)) ->
    waveforms (n_shards, chunk, record_size); defaults to device
    synthesis.  Returns the legacy dict (ltsa_db, welch, spl, tol,
    mean_welch, ...).
    """
    feats = ["welch", "spl"] + (["tol"] if with_tol else [])
    j = (job(m, p).features(*feats).chunk(chunk_records)
         .kernels(use_kernels).limit(max_steps).device(device))
    if reader is not None:
        j = j.source(reader)
    if store is not None:
        j = j.to(store)
    res = j.run()

    welch = res.features["welch"]
    ltsa_db = 10.0 * np.log10(np.maximum(welch, 1e-30)) + p.gain_db
    return {"ltsa_db": ltsa_db, "welch": welch,
            "spl": res.features["spl"], "tol": res.features.get("tol"),
            "mean_welch": res.epoch["mean_welch"],
            "n_records": res.n_records, "plan": res.plan}
