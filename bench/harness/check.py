"""The comparison that decides ``correct``.

The program's outputs, as the sink received them, against the plain
reference (``reference/depam_ref.py``), which decodes the same inputs
itself.  Each function returns named numbers; the
cell's limits file holds the limit of each.

Numbers (all "smaller is closer"):

  * ``welch_rel``   largest relative error of a Welch PSD bin;
  * ``spl_db``      largest wideband-level error, dB;
  * ``tol_db``      largest third-octave-level error, dB;
  * ``mean_rel``    the reduction stage on its own: the published epoch
                    mean Welch PSD against the float64 mean of every row
                    the sink received (largest relative error of a bin).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import depam_ref as R


def params(cfg: dict) -> R.Params:
    """The reference's parameters, read from the configuration itself."""
    return R.Params(fs=float(cfg["fs"]), nfft=int(cfg["nfft"]),
                    window_size=int(cfg["window_size"]),
                    window_overlap=int(cfg["window_overlap"]),
                    record_size_sec=float(cfg["record_size_sec"]),
                    window=cfg["window"], tol_fmin=float(cfg["tol_fmin"]))


def sample(rng: np.random.Generator, lo: int, hi: int, k: int) -> np.ndarray:
    """``k`` distinct record indices in [lo, hi), ascending."""
    k = min(k, hi - lo)
    return np.sort(rng.choice(np.arange(lo, hi), size=k, replace=False))


def reference_features(x: torch.Tensor, p: R.Params, precision: str
                       ) -> dict[str, np.ndarray]:
    w = R.welch(x, p, precision)
    return {"welch": w.double().cpu().numpy(),
            "spl": R.spl(w.double(), p).cpu().numpy(),
            "tol": R.tol(w, p, precision).double().cpu().numpy()}


def feature_numbers(cand: dict, ref: dict) -> dict[str, float]:
    """``cand``/``ref``: welch (k, bins), spl (k,), tol (k, bands)."""
    w_c, w_r = np.asarray(cand["welch"], np.float64), ref["welch"]
    return {
        "welch_rel": float(np.max(np.abs(w_c - w_r) / w_r)),
        "spl_db": float(np.max(np.abs(np.asarray(cand["spl"], np.float64)
                                      - ref["spl"]))),
        "tol_db": float(np.max(np.abs(np.asarray(cand["tol"], np.float64)
                                      - ref["tol"]))),
    }


def mean_rel(published: np.ndarray, rows: np.ndarray) -> float:
    want = np.mean(np.asarray(rows, np.float64), axis=0)
    return float(np.max(np.abs(np.asarray(published, np.float64) - want)
                        / want))


def bf16_mean(rows: np.ndarray, chunk: int, device) -> np.ndarray:
    """The control of the reduction stage: the rows' running sum kept in
    bfloat16, a step of ``chunk`` rows at a time, over the row count."""
    t = torch.tensor(np.asarray(rows, np.float32), device=device)
    acc = torch.zeros(t.shape[1:], dtype=torch.bfloat16, device=device)
    for i in range(0, t.shape[0], chunk):
        acc = (acc.float() + t[i:i + chunk].sum(0)).to(torch.bfloat16)
    return (acc.double() / t.shape[0]).cpu().numpy()


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
