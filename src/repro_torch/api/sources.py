"""Record sources — where waveforms come from.

Two modes behind one interface:

  * **device-synthesized** (:class:`SynthSource`): the step receives
    record *indices* and regenerates the waveforms on the job's device
    from the manifest seed — any record can be recomputed anywhere, with
    no host IO;
  * **host-fed** (:class:`ReaderSource`, :class:`WavSource`): the
    driver fetches ``(n_shards, chunk, record_size)`` waveforms on the
    host (any reader callback, or a directory of wav files) and ships
    them to the device.

Host-fed sources expose ``stream(plan, start, stop)``, the per-step
payload iterator the engine drives.  The base implementation fetches
inline (the synchronous path); :class:`PrefetchSource` runs the wrapped
source through :class:`repro_torch.data.loader.SpeculativeLoader`, so
reads for step k+depth proceed on a host thread pool (with
over-decomposition and speculative re-execution of stragglers) while
the device computes step k.

Host-fed sources carry a **payload dtype**: ``"float32"`` (decoded
waveforms, the default) or ``"int16"`` (raw PCM: half the host->device
bytes; the per-record float32 decode-scale sidecar from
:meth:`Source.scales` rides along and the kernels dequantize as they
load, bitwise-identically).  :class:`PrefetchSource` preserves whatever
the wrapped source ships.

``as_source`` normalizes what users pass to ``job.source()``: ``None``
-> synthesis, a callable -> ``ReaderSource``, a path string ->
``WavSource``, a ``Source`` -> itself.
"""
from __future__ import annotations

import copy
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.manifest import DatasetManifest, ShardPlan
from repro_torch.core.params import DepamParams, PCM_DECODE_SCALE
from repro_torch.data.loader import SpeculativeLoader
from repro_torch.data.wavio import BlockReader, WavRecordReader


def _record_seed(seed: int, idx: int) -> int:
    """A 63-bit generator seed per (manifest seed, record index)."""
    state = np.random.SeedSequence([int(seed), int(idx)]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def synth_record(idx: int, m: DatasetManifest,
                 device: str | torch.device) -> torch.Tensor:
    """Deterministic synthetic PAM record for a global record index:
    noise + a ship-like tonal + a burst of clicks, drawn from a
    ``torch.Generator`` seeded per ``(m.seed, idx)`` on ``device``.

    The same kind of record as the reference's synthesizer, not the same
    bits (that one draws from ``jax.random``).  (record_size,) float32.
    """
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(_record_seed(m.seed, idx))
    t = torch.arange(m.record_size, dtype=torch.float32,
                     device=device) / m.fs
    noise = torch.randn(m.record_size, generator=g, dtype=torch.float32,
                        device=device)
    u = torch.rand(2, generator=g, dtype=torch.float32, device=device)
    tone_f = 50.0 + 400.0 * u[0]
    tone = 0.3 * torch.sin(2 * torch.pi * tone_f * t)
    click_phase = u[1] * 0.9
    clicks = 2.0 * torch.exp(-((t / t[-1] - click_phase) ** 2) * 4e5) \
        * torch.sin(2 * torch.pi * 9000.0 * t)
    return noise + tone + clicks


class Source:
    """Base class.  ``device_synth`` sources hand indices to the step
    (which regenerates records on the device); host-fed sources
    implement ``fetch``."""

    device_synth: bool = False
    payload_dtype: str = "float32"

    def bind(self, m: DatasetManifest, p: DepamParams) -> "Source":
        """Late-bind the manifest/params at job start; returns self."""
        return self

    def with_payload(self, dtype: str) -> "Source":
        """Request a payload transport dtype (``"float32"``/``"int16"``);
        the base accepts only the dtype the source already produces."""
        if dtype == self.payload_dtype:
            return self
        raise ValueError(
            f"{type(self).__name__} cannot ship {dtype!r} payloads "
            f"(it produces {self.payload_dtype!r}; device-synthesized "
            f"sources ship int32 indices and have no host payload)")

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        """Global record indices -> waveforms of shape
        ``indices.shape + (record_size,)`` (zeros for padding slots), in
        ``payload_dtype``.

        The synchronous engine passes ``(n_shards, chunk)`` arrays, but
        the pipelined path (:class:`PrefetchSource`) over-decomposes each
        step and calls ``fetch`` with flat 1-D sub-slices, concurrently
        from a thread pool: pure per index and thread-safe."""
        raise NotImplementedError

    def scales(self, indices: np.ndarray) -> np.ndarray:
        """Per-record float32 decode-scale sidecar for int16 payloads
        (PCM full scale x calibration gain, fused on the host); the
        default is the plain full-scale factor."""
        return np.full(np.asarray(indices).shape, PCM_DECODE_SCALE,
                       np.float32)

    def stream(self, plan: ShardPlan, start: int, stop: int,
               rows: "slice | None" = None) -> Iterator[np.ndarray]:
        """Yield one payload per plan step in [start, stop), in order.

        ``rows`` restricts each step to a slice of the plan's leading
        shard axis: a process that feeds only some executors streams
        only their shard rows, so it never reads another worker's
        files.  None streams the full ``(n_shards, chunk)`` payload."""
        if rows is not None:
            plan = RowSlicePlan(plan, rows)
        for step in range(start, stop):
            yield self.fetch(plan.step_indices(step))

    def close(self) -> None:
        """Release IO resources; called by the engine when the job ends.
        Safe to call twice."""


class RowSlicePlan:
    """A view of a plan restricted to a slice of its shard rows.

    Duck-types the stepping surface (``n_steps`` / ``step_indices`` /
    ``step_mask``) that sources and the SpeculativeLoader drive, so a
    reader can prefetch exactly its own shards' records (its own files,
    under a file-aligned partition) while the step and commit geometry
    stays the full plan's.
    """

    def __init__(self, plan, rows: slice):
        self._plan = plan
        self._rows = rows

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def step_indices(self, step: int) -> np.ndarray:
        return self._plan.step_indices(step)[self._rows]

    def step_mask(self, step: int) -> np.ndarray:
        return self._plan.step_mask(step)[self._rows]


class SynthSource(Source):
    """On-device synthesis from the manifest seed (no host IO)."""

    device_synth = True


class ReaderSource(Source):
    """Any host callback ``indices -> waveforms``, pure per record.

    ``payload_dtype="int16"`` declares that the callback returns raw
    ``<i2`` PCM; ``scales`` may then supply the per-record decode-scale
    sidecar (``indices -> float32``), else the callback's own
    ``scales_for`` when it has one, else the plain full-scale decode.
    A float-returning callback on the int16 path is an error — silent
    requantization would corrupt the data.
    """

    def __init__(self, reader: Callable[[np.ndarray], np.ndarray],
                 payload_dtype: str = "float32",
                 scales: Callable[[np.ndarray], np.ndarray] | None = None):
        self.reader = reader
        self.payload_dtype = payload_dtype
        self._scales = scales

    def with_payload(self, dtype: str) -> "ReaderSource":
        if dtype == self.payload_dtype:
            return self
        if self.payload_dtype == "int16":
            # casting PCM to float32 without the decode scale would be
            # silently 32767x off — refuse instead
            raise ValueError(
                f"{type(self).__name__} wraps a raw-int16 reader and "
                f"cannot ship {dtype!r} payloads; wrap a decoding "
                f"reader instead")
        new = copy.copy(self)
        new.payload_dtype = dtype
        return new

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        out = np.asarray(self.reader(indices))
        want = np.int16 if self.payload_dtype == "int16" else np.float32
        if out.dtype == want:
            return out
        if want == np.int16:
            raise TypeError(
                f"reader returned {out.dtype} but the source ships raw "
                f"int16 PCM; requantizing floats would corrupt the data "
                f"— return '<i2' arrays")
        if out.dtype == np.int16:
            raise TypeError(
                "reader returned raw int16 PCM on the float32 payload "
                "path; casting it would skip the decode scale (32767x "
                "amplitude error) — declare payload_dtype='int16' (or "
                ".payload('int16') on the job) to ship PCM, or have the "
                "reader decode to float32")
        return out.astype(np.float32)

    def scales(self, indices: np.ndarray) -> np.ndarray:
        if self._scales is not None:
            return np.asarray(self._scales(indices), np.float32)
        if hasattr(self.reader, "scales_for"):
            return np.asarray(self.reader.scales_for(indices), np.float32)
        return super().scales(indices)


class WavSource(Source):
    """Reads from a directory of wav files laid out by the manifest
    (uniform miniatures from ``data.wavio.write_dataset`` or a real
    corpus scanned by ``data.wavio.scan_dataset``).

    By default reads go through the block-coalesced
    :class:`~repro_torch.data.wavio.BlockReader` (indices grouped by
    file, contiguous runs merged into single reads, up to
    ``max_open_files`` handles cached in a thread-safe LRU), which is
    bitwise-identical to the per-record path (``coalesced=False``,
    :class:`~repro_torch.data.wavio.WavRecordReader`, the debugging
    oracle).  ``calibration`` applies a per-file sensitivity gain.

    ``payload_dtype="int16"`` (or ``.payload("int16")`` on the job)
    ships raw PCM straight from ``readframes``, with the calibration in
    the :meth:`scales` sidecar instead of a host multiply.
    """

    def __init__(self, root: str, coalesced: bool = True,
                 max_open_files: int = 8, calibration=None,
                 payload_dtype: str = "float32"):
        self.root = root
        self.coalesced = coalesced
        self.max_open_files = max_open_files
        self.calibration = calibration
        self.payload_dtype = payload_dtype
        self._reader = None

    def with_payload(self, dtype: str) -> "WavSource":
        if dtype == self.payload_dtype:
            return self
        # copy, don't mutate: a source reused across jobs must not
        # inherit another job's transport setting
        new = copy.copy(self)
        new.payload_dtype = dtype
        new._reader = None          # bind() attaches the right-mode reader
        return new

    def bind(self, m: DatasetManifest, p: DepamParams) -> "WavSource":
        raw = self.payload_dtype == "int16"
        if self.coalesced:
            self._reader = BlockReader(
                self.root, m, max_open_files=self.max_open_files,
                calibration=self.calibration, raw=raw)
        else:
            self._reader = WavRecordReader(
                self.root, m, calibration=self.calibration, raw=raw)
        return self

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        if self._reader is None:
            raise RuntimeError("WavSource used before bind()")
        out = self._reader(indices)
        return out if out.dtype == self._reader.dtype \
            else np.asarray(out, self._reader.dtype)

    def scales(self, indices: np.ndarray) -> np.ndarray:
        if self._reader is None:
            raise RuntimeError("WavSource used before bind()")
        return self._reader.scales_for(indices)

    def close(self) -> None:
        if self._reader is not None and hasattr(self._reader, "close"):
            self._reader.close()


class PrefetchSource(Source):
    """Drive any host-fed source through a
    :class:`~repro_torch.data.loader.SpeculativeLoader`.

    Wraps ``inner`` so that ``stream`` keeps ``depth`` plan steps of
    reads in flight on a host thread pool of ``workers`` threads, each
    step over-decomposed into ``overdecompose`` read tasks with
    speculative re-execution of stragglers (first completion wins).
    Reads are pure functions of the record index, so the streamed
    payloads are bitwise-identical to ``inner.fetch`` — prefetching
    changes *when* bytes arrive, never *what* arrives.  ``last_stats``
    holds the loader's task statistics after a stream ends.

    ``SoundscapeJob.async_io(depth=...)`` applies this wrapper; wrap
    explicitly to tune workers/over-decomposition or to reuse one
    wrapped source across jobs.
    """

    def __init__(self, inner: "Source | Callable | str", depth: int = 2,
                 workers: int = 4, overdecompose: int = 4,
                 speculate_factor: float = 4.0,
                 min_speculate_sec: float = 0.05):
        inner = as_source(inner)
        if inner.device_synth:
            raise ValueError(
                "PrefetchSource wraps host-fed sources; device-"
                "synthesized sources have no host IO to prefetch")
        self.inner = inner
        self.depth = max(1, depth)
        self.workers = workers
        self.overdecompose = overdecompose
        self.speculate_factor = speculate_factor
        self.min_speculate_sec = min_speculate_sec
        self.last_stats: dict | None = None
        self._manifest: DatasetManifest | None = None

    @property
    def payload_dtype(self) -> str:
        """Prefetching never changes the bytes: the wrapped source's
        transport dtype (and its decode-scale sidecar) pass through."""
        return self.inner.payload_dtype

    def with_payload(self, dtype: str) -> "PrefetchSource":
        if dtype == self.payload_dtype:
            return self
        new = copy.copy(self)
        new.inner = self.inner.with_payload(dtype)
        return new

    def bind(self, m: DatasetManifest, p: DepamParams) -> "PrefetchSource":
        self.inner = self.inner.bind(m, p)
        self._manifest = m
        return self

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        return self.inner.fetch(indices)

    def scales(self, indices: np.ndarray) -> np.ndarray:
        return self.inner.scales(indices)

    def close(self) -> None:
        self.inner.close()

    def stream(self, plan: ShardPlan, start: int, stop: int,
               rows: "slice | None" = None) -> Iterator[np.ndarray]:
        if rows is not None:
            plan = RowSlicePlan(plan, rows)
        # read tasks split along the manifest's file boundaries (when
        # bound), so each task coalesces into sequential IO on one
        # file; a partitioned plan's span offsets join the cut set, so
        # no read task straddles two worker slices
        boundaries = None if self._manifest is None \
            else self._manifest.file_offsets
        offsets = getattr(plan, "offsets", None)
        if boundaries is not None and offsets is not None:
            boundaries = np.union1d(boundaries,
                                    np.asarray(offsets, np.int64))
        loader = SpeculativeLoader(
            self.inner.fetch, plan, workers=self.workers,
            overdecompose=self.overdecompose, depth=self.depth,
            speculate_factor=self.speculate_factor,
            min_speculate_sec=self.min_speculate_sec,
            boundaries=boundaries)
        try:
            for _step, payload, _mask in loader.iter_steps(start, stop):
                yield payload
        finally:
            self.last_stats = loader.stats()
            loader.close()


def as_source(src) -> Source:
    """Normalize a user-supplied source (see module docstring)."""
    if src is None:
        return SynthSource()
    if isinstance(src, Source):
        return src
    if isinstance(src, str):
        return WavSource(src)
    if callable(src):
        return ReaderSource(src)
    raise TypeError(f"cannot interpret {type(src).__name__} as a Source")
