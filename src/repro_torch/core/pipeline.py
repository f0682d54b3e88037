"""Legacy pipeline entry point — a thin shim over ``repro_torch.api``.

Keeps the reference's ``run_pipeline()`` return payload for existing
callers; new code should use::

    from repro_torch import api
    api.job(manifest, params).features("welch", "spl", "tol").run()

``mesh``/``data_axes`` lay the job over the executors of a host mesh
(``repro_torch.launch.mesh``), as ``job(...).on(mesh, data_axes)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.api import job
from .manifest import DatasetManifest
from .params import DepamParams


def run_pipeline(m: DatasetManifest, p: DepamParams, mesh=None,
                 data_axes: tuple[str, ...] = ("data",),
                 chunk_records: int = 8, store=None, with_tol: bool = True,
                 use_kernels: bool = True,
                 reader: Callable[[np.ndarray], np.ndarray] | None = None,
                 max_steps: int | None = None,
                 device: str | torch.device | None = None):
    """Drive the full DEPAM job; resumable via ``store`` (feature store).

    reader: optional host function global_indices((n_shards, chunk)) ->
    waveforms (n_shards, chunk, record_size); defaults to device
    synthesis.  ``device`` defaults to the CUDA device, or to the
    mesh's devices when a mesh is given.  Returns the legacy dict
    (ltsa_db, welch, spl, tol, mean_welch, ...).
    """
    feats = ["welch", "spl"] + (["tol"] if with_tol else [])
    j = (job(m, p).features(*feats).on(mesh, data_axes)
         .chunk(chunk_records).kernels(use_kernels).limit(max_steps))
    if device is not None:
        j = j.device(device)
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
