"""The feature registry: what the engine knows how to compute.

A :class:`FeatureSpec` declares

  * ``shape(manifest, params)`` — the per-record trailing shape the
    store lays out; ``None`` marks a *reduction-only* feature (``ltsa``,
    ``minmax``): its per-step value feeds reductions but is never stored
    per record;
  * ``compute(ctx)`` — a function from the shared
    :class:`FeatureContext` (records + cached Welch PSD) to a
    ``(batch, *shape)`` tensor;
  * ``fill`` — the value written into padding slots beyond the manifest
    end (0 for linear power, -inf for dB levels);
  * optional ``setup(manifest, params)`` — host-side constants (e.g. the
    TOL band matrix), moved to the job's device once per job;
  * optional ``reductions`` — :class:`Reduction` instances turning the
    per-record value into windowed products or whole-epoch aggregates,
    accumulated in the engine's on-device carry.

Every selected spec computes from the SAME context in one step, so
("welch", "spl", "tol") runs the Welch PSD once.  This slice ports the
paper's features (welch, spl, tol) and the windowed ltsa/minmax; the
spectrogram features (percentiles, spd) and the ragged detection
features (events, impulsive) come with their kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import spectra
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.core.tol import band_matrix as make_band_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.common import dequantize


class FeatureContext:
    """Shared per-step state handed to every ``FeatureSpec.compute``.

    ``records`` is the flat ``(batch, record_size)`` float32 waveform
    batch on the job's device.  The Welch PSD is computed lazily and
    cached, so N features selecting it compute it exactly once.

    With the int16 payload the context holds the raw ``(batch,
    record_size)`` PCM plus the per-record decode-scale sidecar
    (``scales``); the Welch PSD then hands the PCM straight to the
    kernels, which dequantize as they load, and ``ctx.records``
    dequantizes lazily (bitwise-equal to the host decode) only for
    features that need the waveform itself.
    """

    def __init__(self, records: torch.Tensor, params: DepamParams,
                 use_kernels: bool, consts: dict[str, dict],
                 scales: torch.Tensor | None = None):
        self.quantized = records.dtype == torch.int16
        self.pcm = records if self.quantized else None
        self.scales = scales
        self.params = params
        self.use_kernels = use_kernels
        self._consts = consts
        self._cache: dict[str, torch.Tensor] = {}
        if not self.quantized:
            self._cache["records"] = records

    def const(self, feature: str, name: str) -> torch.Tensor:
        """A host-side constant declared by ``FeatureSpec.setup``."""
        return self._consts[feature][name]

    @property
    def records(self) -> torch.Tensor:
        """(batch, record_size) float32 waveforms (lazy dequantize)."""
        if "records" not in self._cache:
            self._cache["records"] = dequantize(self.pcm, self.scales)
        return self._cache["records"]

    @property
    def welch(self) -> torch.Tensor:
        """(batch, n_bins) Welch PSD: the kernels, or the plain
        ``core.spectra`` path under ``.kernels(False)``."""
        if "welch" not in self._cache:
            if self.use_kernels:
                src = self.pcm if self.quantized else self.records
                out = ops.welch_psd(src, self.params, scales=self.scales
                                    if self.quantized else None)
            else:
                out = spectra.welch_psd(self.records, self.params)
            self._cache["welch"] = out
        return self._cache["welch"]


# ---------------------------------------------------------------------------
# Windows & reductions — the multi-resolution reduction protocol.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Window:
    """A named partition of the record index space into time windows.

      * ``records`` — fixed-size windows of ``records`` consecutive
        records (the last window may be partial);
      * ``file`` — one window per manifest file;
      * ``epoch`` — the single window covering everything;
      * ``job`` — resolved by the engine to whatever the job builder's
        ``.window(...)`` selected (``epoch`` when unset).

    Windows follow the plan's global record order, so they close as the
    committed cursor advances and the engine flushes them mid-job.
    """

    kind: str                      # "epoch" | "records" | "file" | "job"
    records: int | None = None

    def __post_init__(self):
        if self.kind not in ("epoch", "records", "file", "job"):
            raise ValueError(f"unknown window kind {self.kind!r}")
        if (self.kind == "records") != (self.records is not None):
            raise ValueError("records= is required for (exactly) the "
                             "'records' window kind")
        if self.records is not None and self.records < 1:
            raise ValueError(f"window records must be >= 1, "
                             f"got {self.records}")

    @property
    def key(self) -> str:
        """Stable name, e.g. ``records:512`` — the window part of every
        carry key (``__r:<window>:<out>:<field>``)."""
        return f"records:{self.records}" if self.kind == "records" \
            else self.kind

    def edges(self, m: DatasetManifest) -> np.ndarray:
        """Record-offset boundaries, shape (n_windows + 1,): window ``i``
        covers global records [edges[i], edges[i+1])."""
        if self.kind == "epoch":
            return np.asarray([0, m.n_records], np.int64)
        if self.kind == "records":
            n = int(np.ceil(max(m.n_records, 1) / self.records))
            e = np.arange(n + 1, dtype=np.int64) * self.records
            e[-1] = m.n_records
            return e
        if self.kind == "file":
            return np.asarray(m.file_offsets, np.int64)
        raise ValueError("the 'job' window must be resolved by the "
                         "engine before use")

    def n_windows(self, m: DatasetManifest) -> int:
        return len(self.edges(m)) - 1

    def ids(self, indices: np.ndarray, m: DatasetManifest) -> np.ndarray:
        """Global record indices -> window ids (host-side, per step).
        Padding indices beyond the manifest clamp to the last window —
        their contributions are masked to the identity anyway."""
        idx = np.minimum(np.asarray(indices, np.int64),
                         max(m.n_records - 1, 0))
        if self.kind == "epoch":
            return np.zeros(idx.shape, np.int32)
        if self.kind == "records":
            return (idx // self.records).astype(np.int32)
        e = self.edges(m)
        return (np.searchsorted(e, idx, side="right") - 1).astype(np.int32)


EPOCH_WINDOW = Window("epoch")
JOB_WINDOW = Window("job")


@dataclasses.dataclass(frozen=True)
class StateField:
    """One named array in a reduction's per-window carry state.

    ``merge`` names the associative combine the engine applies within a
    step (a fixed-order reduce over the records that hit each window)
    and across steps (carry ⊕ step partial):

      * ``"sum"`` — plain addition;
      * ``"ksum"`` — Kahan-compensated float32 addition, with a
        companion compensation array under ``<key>:c``; ``finalize``
        receives the corrected sum;
      * ``"min"`` / ``"max"`` — elementwise extrema.

    ``init`` is the merge identity; ``dtype`` is ``"float32"`` or
    ``"int32"`` (exact counts).
    """

    name: str
    shape: tuple[int, ...] = ()
    merge: str = "sum"
    dtype: str = "float32"
    init: float = 0.0

    def __post_init__(self):
        if self.merge not in ("sum", "ksum", "min", "max"):
            raise ValueError(f"unknown merge op {self.merge!r}")
        if self.dtype not in ("float32", "int32"):
            raise ValueError(f"unsupported state dtype {self.dtype!r}")
        if self.merge == "ksum" and self.dtype != "float32":
            raise ValueError("ksum compensation is float32-only")


@dataclasses.dataclass(frozen=True)
class Reduction:
    """A windowed (or epoch) reduction over a feature's per-record value.

      * ``init(manifest, params)`` — the per-window carry layout, a tuple
        of :class:`StateField`;
      * ``update(value, mask)`` — maps the feature's flat ``(batch, ...)``
        step value and live mask to per-record contributions
        ``{field: (batch, *field.shape)}`` (masked slots contribute the
        field's identity);
      * ``finalize(state)`` — host-side, row-wise over windows: the
        float64 copy of the carry (``ksum`` fields corrected) -> the
        published ``(n_windows, *out_shape)`` array.

    ``window`` is :data:`JOB_WINDOW` (the builder's ``.window(...)``) or
    an explicit window such as :data:`EPOCH_WINDOW` (``mean_welch``,
    published in ``JobResult.epoch``).
    """

    out_name: str
    init: Callable[[DatasetManifest, DepamParams], tuple[StateField, ...]]
    update: Callable[[torch.Tensor, torch.Tensor], dict[str, torch.Tensor]]
    finalize: Callable[[dict[str, np.ndarray]], np.ndarray]
    out_shape: Callable[[DatasetManifest, DepamParams], tuple[int, ...]]
    window: Window = JOB_WINDOW
    doc: str = ""


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """A registered feature workload (see module docstring)."""

    name: str
    shape: Callable[[DatasetManifest, DepamParams],
                    tuple[int, ...]] | None
    compute: Callable[[FeatureContext], torch.Tensor]
    fill: float = 0.0
    setup: Callable[[DatasetManifest, DepamParams], dict] | None = None
    reductions: tuple[Reduction, ...] = ()
    doc: str = ""


_REGISTRY: dict[str, FeatureSpec] = {}


def register(spec: FeatureSpec, *, overwrite: bool = False) -> FeatureSpec:
    """Add a feature to the registry; returns the spec for chaining."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"feature {spec.name!r} already registered "
            f"(pass overwrite=True to replace)")
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_feature(name: str) -> FeatureSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown feature {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def feature_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_features(feats: Sequence[str | FeatureSpec]) -> list[FeatureSpec]:
    """Names and/or inline specs -> specs, order preserved, no dups."""
    out: list[FeatureSpec] = []
    seen: set[str] = set()
    for f in feats:
        spec = f if isinstance(f, FeatureSpec) else get_feature(f)
        if spec.name in seen:
            raise ValueError(f"feature {spec.name!r} selected twice")
        seen.add(spec.name)
        out.append(spec)
    return out


# ---------------------------------------------------------------------------
# Built-in features — the paper's workload, as registry entries.
# ---------------------------------------------------------------------------

def _finalize_mean(state: dict[str, np.ndarray]) -> np.ndarray:
    """sum/count per window; windows that never saw a record publish
    NaN, not 0."""
    count = state["count"][..., None]
    mean = state["sum"] / np.maximum(count, 1.0)
    return np.where(count > 0, mean, np.nan)


def mean_reduction(out_name: str, n_cols, *, window: Window = JOB_WINDOW,
                   kahan: bool = False, doc: str = "") -> Reduction:
    """Windowed mean of a ``(batch, n_cols)`` feature value.

    ``n_cols`` is a ``(manifest, params) -> int`` callable (or an int).
    ``kahan=True`` compensates the float32 sums (the whole-epoch mean
    wants it)."""
    cols = n_cols if callable(n_cols) else (lambda m, p: n_cols)
    return Reduction(
        out_name=out_name,
        init=lambda m, p: (
            StateField("sum", (cols(m, p),),
                       merge="ksum" if kahan else "sum"),
            StateField("count", (), merge="sum", dtype="int32")),
        update=lambda v, mask: {
            "sum": v * mask[:, None].to(v.dtype),
            "count": mask.to(torch.int32)},
        finalize=_finalize_mean,
        out_shape=lambda m, p: (cols(m, p),),
        window=window, doc=doc)


register(FeatureSpec(
    name="welch",
    shape=lambda m, p: (p.n_bins,),
    compute=lambda ctx: ctx.welch,
    fill=0.0,
    reductions=(mean_reduction(
        "mean_welch", lambda m, p: p.n_bins, window=EPOCH_WINDOW,
        kahan=True,
        doc="Epoch mean Welch PSD (the paper's final join)."),),
    doc="Per-record Welch PSD (linear, scipy 'density' scaling)."))


register(FeatureSpec(
    name="spl",
    shape=lambda m, p: (),
    compute=lambda ctx: spectra.spl_wideband(ctx.welch, ctx.params),
    fill=-float("inf"),
    doc="Wideband SPL per record, dB re 1 uPa."))


register(FeatureSpec(
    name="tol",
    shape=lambda m, p: (make_band_matrix(p).shape[1],),
    setup=lambda m, p: {"band_matrix": make_band_matrix(p)},
    compute=lambda ctx: (
        (ops.tol_levels if ctx.use_kernels else spectra.tol_levels)(
            ctx.welch, ctx.const("tol", "band_matrix"), ctx.params)),
    fill=-float("inf"),
    doc="Third-octave levels per record, dB (IEC 61260 base-10 bands)."))


register(FeatureSpec(
    name="ltsa",
    shape=None,
    compute=lambda ctx: ctx.welch,
    reductions=(mean_reduction(
        "ltsa", lambda m, p: p.n_bins,
        doc="Windowed mean Welch PSD — the long-term spectral average "
            "panel (linear; 10*log10 for the dB plot)."),),
    doc="LTSA: mean Welch PSD per time window."))


def _extremum_reduction(out_name: str, op: str) -> Reduction:
    sign = np.inf if op == "min" else -np.inf

    def update(v, mask):
        return {op: torch.where(mask[:, None], v,
                                torch.tensor(float(sign), dtype=v.dtype,
                                             device=v.device)),
                "count": mask.to(torch.int32)}

    def finalize(state):
        count = state["count"][..., None]
        return np.where(count > 0, state[op], np.nan)

    return Reduction(
        out_name=out_name,
        init=lambda m, p: (
            StateField(op, (p.n_bins,), merge=op, init=sign),
            StateField("count", (), merge="sum", dtype="int32")),
        update=update,
        finalize=finalize,
        out_shape=lambda m, p: (p.n_bins,),
        doc=f"Windowed {op} Welch spectrum.")


register(FeatureSpec(
    name="minmax",
    shape=None,
    compute=lambda ctx: ctx.welch,
    reductions=(_extremum_reduction("min_welch", "min"),
                _extremum_reduction("max_welch", "max")),
    doc="Windowed min/max Welch spectrum per frequency bin."))
