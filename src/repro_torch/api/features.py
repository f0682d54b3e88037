"""The feature registry: what the engine knows how to compute.

A :class:`FeatureSpec` declares

  * ``shape(manifest, params)`` — the per-record trailing shape the
    store lays out; ``None`` marks a *reduction-only* feature (``ltsa``,
    ``minmax``): its per-step value feeds reductions but is never stored
    per record;
  * ``compute(ctx)`` — a function from the shared
    :class:`FeatureContext` (records + cached Welch / frame-PSD
    intermediates) to a ``(batch, *shape)`` tensor;
  * ``fill`` — the reference's value for padding slots beyond the
    manifest end (0 for linear power, -inf for dB levels), kept for its
    signature: the port never writes padding rows, since the host drops
    them before any sink sees a step;
  * optional ``setup(manifest, params)`` — host-side constants (e.g. the
    TOL band matrix), moved to the job's device once per job;
  * optional ``reductions`` — :class:`Reduction` instances turning the
    per-record value into windowed products or whole-epoch aggregates,
    accumulated in the engine's on-device carry.

Every selected spec computes from the SAME context in one step, so
("welch", "spl", "tol") runs the Welch PSD once and ("percentiles",
"spd", "events") the per-frame PSD once.  The registry holds the
paper's features (welch, spl, tol), the windowed ltsa/minmax/spd, the
spectrogram percentiles, and the ragged detection features (events,
impulsive: ``ragged=True``, see :class:`FeatureSpec`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import spectra
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.core.tol import band_matrix as make_band_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.common import dequantize
from .graphs import StepGraphs


class FeatureContext:
    """Shared per-step state handed to every ``FeatureSpec.compute``.

    ``payload`` is the step's flat ``(batch, record_size)`` batch on the
    job's device: float32 waveforms, or raw int16 PCM with the
    per-record decode-scale sidecar ``scales`` (None for float32).  Every
    op gets that one pair and ``kernel=use_kernels``, and
    ``kernels.ops`` picks kernel or plain and dequantizes where its
    route needs it.  The intermediates (Welch PSD, per-frame PSD, the
    frame statistics, detected events) are computed lazily and cached,
    so N features selecting one compute it exactly once.

    The frame statistics (:data:`FRAME_STATS`: the dB spectrogram, the
    spectrum percentiles, the frame SPL and peak bins) are one chain of
    ``graphs`` (the job's :class:`~repro_torch.api.graphs.StepGraphs`)
    over the per-frame PSD: the first request of a step computes every
    statistic the job's features read, as ``graphs.uses`` recorded them
    in the job's first step, where each is computed alone as asked.
    ``ctx.records`` is the float32 waveform, dequantized lazily
    (bitwise-equal to the host decode) only for features that need the
    waveform itself.
    """

    def __init__(self, records: torch.Tensor, params: DepamParams,
                 use_kernels: bool, consts: dict[str, dict],
                 scales: torch.Tensor | None = None,
                 graphs: StepGraphs | None = None):
        self.payload = records
        self.scales = scales
        self.params = params
        self.use_kernels = use_kernels
        self.graphs = graphs or StepGraphs()
        self._consts = consts
        self._cache: dict[str, torch.Tensor] = {}

    def const(self, feature: str, name: str) -> torch.Tensor:
        """A host-side constant declared by ``FeatureSpec.setup``."""
        return self._consts[feature][name]

    @property
    def records(self) -> torch.Tensor:
        """(batch, record_size) float32 waveforms (lazy dequantize)."""
        if self.payload.dtype != torch.int16:
            return self.payload
        if "records" not in self._cache:
            self._cache["records"] = dequantize(self.payload, self.scales)
        return self._cache["records"]

    def _psd(self, key: str, fn) -> torch.Tensor:
        """A cached PSD intermediate of the step's payload."""
        if key not in self._cache:
            self._cache[key] = fn(self.payload, self.params,
                                  scales=self.scales,
                                  kernel=self.use_kernels)
        return self._cache[key]

    @property
    def welch(self) -> torch.Tensor:
        """(batch, n_bins) Welch PSD."""
        return self._psd("welch", ops.welch_psd)

    @property
    def frame_psd(self) -> torch.Tensor:
        """(batch, n_frames, n_bins) per-frame PSD (the spectrogram)."""
        return self._psd("frame_psd", ops.frame_psd)

    def _frame_stat(self, name: str) -> torch.Tensor:
        if name not in self._cache:
            uses = self.graphs.uses.setdefault("frame_stats", [])
            if name in uses:
                names = tuple(uses)
                self._cache.update(zip(names, self.graphs.run(
                    "frame_stats", functools.partial(
                        frame_stats, p=self.params, names=names),
                    (self.frame_psd,), names)))
            else:
                db = self.frame_db if name == "percentiles" else None
                uses.append(name)
                self._cache[name] = frame_stats(
                    self.frame_psd, self.params, (name,), db)[0]
        return self._cache[name]

    @property
    def frame_db(self) -> torch.Tensor:
        """(batch, n_frames, n_bins) per-frame PSD in dB (percentiles
        and spd share it)."""
        return self._frame_stat("frame_db")

    @property
    def percentiles(self) -> torch.Tensor:
        """(batch, n_pct, n_bins) :data:`SPECTRUM_PERCENTILES` of the dB
        spectrogram along frames, per bin."""
        return self._frame_stat("percentiles")

    @property
    def frame_spl(self) -> torch.Tensor:
        """(batch, n_frames) wideband SPL per analysis frame, dB — the
        trace detection scans."""
        return self._frame_stat("frame_spl")

    @property
    def frame_peak_bin(self) -> torch.Tensor:
        """(batch, n_frames) int32 argmax PSD bin per frame (the first
        maximum, as ``jnp.argmax``)."""
        return self._frame_stat("frame_peak_bin")

    @property
    def events(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Detected events, cached so ``events`` and ``impulsive`` share
        one scan: ``(counts (batch,) int32, rows (batch, event_capacity,
        4) float32)`` with rows ``(onset_frame, n_frames, peak_bin,
        peak_db)``.  Thresholds come off ``ctx.params``."""
        if "events" not in self._cache:
            self._cache["events"] = ops.detect_events(
                self.frame_spl, self.frame_peak_bin, self.params,
                kernel=self.use_kernels)
        return self._cache["events"]


# pypam-style soundscape statistics: per-record percentiles of the frame
# spectrogram (dB), per frequency bin.
SPECTRUM_PERCENTILES = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

FRAME_STATS = ("frame_db", "percentiles", "frame_spl", "frame_peak_bin")


def spectrum_percentiles(frame_db: torch.Tensor) -> torch.Tensor:
    """numpy's (and ``jnp.percentile``'s) default ``linear`` method,
    written out over one sort along the frame axis: ``torch.quantile``
    refuses inputs above 2**24 elements, which a step's spectrogram
    reaches.  The interpolation positions are host-side constants."""
    srt = torch.sort(frame_db, dim=-2).values       # (batch, F, n_bins)
    n = srt.shape[-2]
    out = []
    for q in SPECTRUM_PERCENTILES:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        t = pos - lo
        a, b = srt[:, lo], srt[:, hi]
        diff = b - a
        # numpy's _lerp: from the nearer end, so t = 0 and t = 1 are exact
        out.append(a + diff * t if t < 0.5 else b - diff * (1.0 - t))
    return torch.stack(out, dim=1)                  # (batch, n_pct, n_bins)


def frame_stats(frame_psd: torch.Tensor, p: DepamParams,
                names: tuple[str, ...],
                db: torch.Tensor | None = None) -> tuple:
    """The frame statistics ``names`` (of :data:`FRAME_STATS`) of a
    ``(batch, n_frames, n_bins)`` per-frame PSD, in that order; ``db``
    is the dB spectrogram where the caller has it."""
    if db is None and {"frame_db", "percentiles"} & set(names):
        db = spectra.db(frame_psd, p)
    out = []
    for name in names:
        if name == "frame_db":
            out.append(db)
        elif name == "percentiles":
            out.append(spectrum_percentiles(db))
        elif name == "frame_spl":
            power = torch.sum(frame_psd, dim=-1) * p.df
            out.append(spectra.db(power, p))
        elif name == "frame_peak_bin":
            out.append(torch.argmax(frame_psd, dim=-1).to(torch.int32))
        else:
            raise KeyError(f"unknown frame statistic {name!r}; "
                           f"known: {FRAME_STATS}")
    return tuple(out)


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
    """A registered feature workload (see module docstring).

    ``ragged=True`` marks the third output kind beside fixed-shape and
    reduction-only: ``compute`` returns a count-prefixed pair
    ``(counts (batch,) int32, rows (batch, capacity, len(columns))
    float32)``.  ``counts`` is the TRUE per-record event count
    (``counts > capacity`` flags overflow), and the engine routes the
    host-compacted rows to the sink's append-only event log.  Ragged
    specs must name their ``columns`` and cannot also declare reductions
    or a dense ``shape``.
    """

    name: str
    shape: Callable[[DatasetManifest, DepamParams],
                    tuple[int, ...]] | None
    compute: Callable[[FeatureContext], torch.Tensor]
    fill: float = 0.0
    setup: Callable[[DatasetManifest, DepamParams], dict] | None = None
    reductions: tuple[Reduction, ...] = ()
    ragged: bool = False
    columns: tuple[str, ...] = ()
    doc: str = ""

    def __post_init__(self):
        if self.ragged:
            if not self.columns:
                raise ValueError(
                    f"ragged feature {self.name!r} must declare columns")
            if self.shape is not None or self.reductions:
                raise ValueError(
                    f"ragged feature {self.name!r} cannot also declare a "
                    f"dense shape or reductions")
        elif self.columns:
            raise ValueError(
                f"feature {self.name!r}: columns= is only meaningful "
                f"with ragged=True")


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
    compute=lambda ctx: ops.tol_levels(
        ctx.welch, ctx.const("tol", "band_matrix"), ctx.params,
        kernel=ctx.use_kernels),
    fill=-float("inf"),
    doc="Third-octave levels per record, dB (IEC 61260 base-10 bands)."))


register(FeatureSpec(
    name="percentiles",
    shape=lambda m, p: (len(SPECTRUM_PERCENTILES), p.n_bins),
    compute=lambda ctx: ctx.percentiles,
    fill=-float("inf"),
    doc="Spectrum percentile levels per record (dB), pypam-style."))


register(FeatureSpec(
    name="ltsa",
    shape=None,
    compute=lambda ctx: ctx.welch,
    reductions=(mean_reduction(
        "ltsa", lambda m, p: p.n_bins,
        doc="Windowed mean Welch PSD — the long-term spectral average "
            "panel (linear; 10*log10 for the dB plot)."),),
    doc="LTSA: mean Welch PSD per time window."))


# SPD histogram layout (pypam compute_spd): dB bins of width SPD_DB_STEP
# spanning [SPD_DB_MIN, SPD_DB_MAX), per frequency bin, per window.
# Out-of-range frames are dropped, exactly like np.histogram's range=.
SPD_DB_MIN = -120.0
SPD_DB_MAX = 60.0
SPD_DB_STEP = 3.0
SPD_N_DB = int(round((SPD_DB_MAX - SPD_DB_MIN) / SPD_DB_STEP))


def _spd_update(db: torch.Tensor, mask: torch.Tensor) -> dict:
    """Per-record frame-count histogram: (batch, n_frames, n_bins) dB ->
    {counts: (batch, n_bins, SPD_N_DB) int32}.  One ``index_add_`` of
    integer ones into a histogram of fixed size, over the flat ids offset
    per record: integer adds give the same counts in any order, so the
    atomics a GPU index_add uses change nothing.  (``torch.bincount``
    would read the largest id back to the host on a CUDA tensor, a
    synchronization in every step.)"""
    batch, _, n_bins = db.shape
    n_ids = n_bins * SPD_N_DB + 1            # the last id drops a frame
    freq = torch.arange(n_bins, device=db.device)
    dbin = torch.floor((db - SPD_DB_MIN) / SPD_DB_STEP).to(torch.int64)
    valid = (db >= SPD_DB_MIN) & (db < SPD_DB_MAX) & mask[:, None, None]
    ids = torch.where(valid, freq * SPD_N_DB + dbin, n_ids - 1)
    ids = ids + n_ids * torch.arange(batch, device=db.device)[:, None, None]
    ids = ids.reshape(-1)
    h = torch.zeros(batch * n_ids, dtype=torch.int32, device=db.device)
    h.index_add_(0, ids, torch.ones((), dtype=torch.int32,
                                    device=db.device).expand(ids.numel()))
    h = h.reshape(batch, n_ids)[:, :-1].reshape(batch, n_bins, SPD_N_DB)
    return {"counts": h}


def _spd_finalize(state: dict[str, np.ndarray]) -> np.ndarray:
    """Counts -> empirical probability density per (window, freq bin):
    rows integrate to 1 over dB (np.histogram density=True semantics,
    normalized by the in-range frame count per frequency bin)."""
    counts = state["counts"]
    total = counts.sum(axis=-1, keepdims=True)
    return counts / np.where(total > 0, total * SPD_DB_STEP, 1.0)


register(FeatureSpec(
    name="spd",
    shape=None,
    compute=lambda ctx: ctx.frame_db,
    reductions=(Reduction(
        out_name="spd",
        init=lambda m, p: (
            StateField("counts", (p.n_bins, SPD_N_DB), dtype="int32"),),
        update=_spd_update,
        finalize=_spd_finalize,
        out_shape=lambda m, p: (p.n_bins, SPD_N_DB),
        doc="Spectral probability density: per-window histogram of the "
            "frame-PSD dB levels, per frequency bin (pypam "
            "compute_spd)."),),
    doc="SPD: windowed dB-histogram of the frame spectrogram, "
        "normalized to a probability density per frequency bin."))


def _extremum_reduction(out_name: str, op: str) -> Reduction:
    sign = np.inf if op == "min" else -np.inf

    def update(v, mask):
        return {op: torch.where(mask[:, None], v, float(sign)),
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


# ---------------------------------------------------------------------------
# Ragged detection workloads (pypam loud_event_detector / pile-driving
# impulsive metrics).  Both ride the cached frame-PSD trace and share
# ONE threshold+compaction scan via ctx.events.
# ---------------------------------------------------------------------------

EVENT_COLUMNS = ("onset", "duration", "peak_bin", "peak_db")
IMPULSIVE_COLUMNS = ("sel", "peak", "kurtosis", "rise_time")


register(FeatureSpec(
    name="events",
    shape=None,
    compute=lambda ctx: ctx.events,
    ragged=True,
    columns=EVENT_COLUMNS,
    doc="Loud-event windows per record (pypam loud_event_detector): "
        "Schmitt-trigger detection over the per-frame wideband SPL, "
        "rows = (onset_frame, n_frames, peak_bin, peak_db)."))


def _impulsive_compute(ctx: FeatureContext):
    """Per-event impulsive metrics from the raw waveform (pypam
    pile-driving suite): SEL, zero-to-peak level, kurtosis, rise time.

    Each detected event's sample span is [onset*hop,
    (onset+dur-1)*hop + window_size) clipped to the record.  The step's
    own payload goes to ``ops.impulsive_metrics``: on the int16 path the
    raw PCM and its decode scales, so the dequantized ``ctx.records`` is
    never built.  The int16 and float32 payloads agree bitwise because
    both versions turn a sample into the same float32 ``x`` (one exact
    convert and one float32 multiply, ``common.dequantize``'s) and then
    run the same operations in an order that does not depend on the
    payload.  The kernel (K7) reads each event's samples alone, with no
    float atomics; ``.kernels(False)`` and CPU jobs run the plain
    version.  Only capacity rows come home.
    """
    counts, rows = ctx.events
    return counts, ops.impulsive_metrics(
        ctx.payload, counts, rows, ctx.params, scales=ctx.scales,
        kernel=ctx.use_kernels)


register(FeatureSpec(
    name="impulsive",
    shape=None,
    compute=_impulsive_compute,
    ragged=True,
    columns=IMPULSIVE_COLUMNS,
    doc="Per-event impulsive metrics from the raw waveform (pypam "
        "pile-driving suite): SEL (dB re 1 uPa^2 s), zero-to-peak level "
        "(dB), kurtosis (m4/m2^2), rise time (s)."))
