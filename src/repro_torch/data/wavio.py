"""Wav dataset IO (stdlib `wave`, int16 PCM) — the HDFS stand-in.

A copy of the reference's ``data/wavio.py`` (numpy and the stdlib
only), with its imports pointed at the port.

The paper's dataset is 1807 x 45-min wav files at 32768 Hz, and its
scalability comes from coalesced HDFS *block* reads, not per-record
seeks.  This module provides both ends of that spectrum:

  * :class:`WavRecordReader` — the reference reader: one open + seek +
    read per record.  Simple, obviously correct, and the bitwise oracle
    for everything else; also the worst case for file-system traffic.
  * :class:`BlockReader` — the production reader: a batch of record
    indices is grouped by file, contiguous records merge into single
    ``readframes`` calls, and file handles are served from a bounded
    thread-safe LRU cache (a prefetching source may call ``fetch``
    concurrently from a read pool).  Payloads are bitwise-identical to
    the per-record reader; only the number of opens/seeks changes.

Both readers accept a pypam-style per-file **calibration gain**
(hydrophone sensitivity).  Decode is ONE float32 multiply per sample:
the 1/32767 PCM full-scale factor and the gain are fused on the host
into a per-file ``scale`` (float32, single rounding), so calibration
costs no extra pass over the samples.

Both readers also support **raw payload transport** (``raw=True``):
``fetch`` returns the ``<i2`` PCM exactly as read from disk — no float
conversion, half the bytes — and ``scales_for(indices)`` returns the
per-record float32 decode-scale *sidecar* vector instead.  Applying
``pcm.astype(float32) * scale`` (one multiply, anywhere — host or
inside a device kernel) reproduces the float path bitwise; that is the
contract the int16 host→device transport path is built on.

``scan_dataset(root)`` builds a :class:`DatasetManifest` from the real
wav headers in a directory — heterogeneous file lengths and arbitrary
names — so real deployments need no synthetic-layout assumptions.
``write_dataset`` writes synthetic miniatures of either layout.
"""
from __future__ import annotations

import collections
import os
import threading
import warnings
import wave

import numpy as np

from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import PCM_DECODE_SCALE
from repro_torch.faults.errors import TruncatedRecordError
from repro_torch.meta.instrument import Instrument
from repro_torch.meta.timestamps import timestamps_for


def write_dataset(root: str, m: DatasetManifest, gen=None) -> list[str]:
    """Write one wav file per manifest entry (uniform or variable)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(m.seed)
    paths = []
    for fi in range(m.n_files):
        path = os.path.join(root, m.file_name(fi))
        n = m.records_in_file(fi) * m.record_size
        if gen is not None:
            x = gen(fi, n)
        else:
            x = rng.standard_normal(n) * 0.05
        pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(m.fs))
            w.writeframes(pcm.tobytes())
        paths.append(path)
    return paths


def scan_dataset(root: str, record_size: int, *, fs: float | None = None,
                 seed: int = 0,
                 timestamps: str | bool | None = "auto"
                 ) -> DatasetManifest:
    """Build a manifest from the real wav headers under ``root``.

    Files are taken in sorted name order; each contributes
    ``frames // record_size`` records.  A trailing partial record is
    dropped from the record grid (the paper's segmentation does the
    same) but never silently: one aggregated ``RuntimeWarning`` names
    the total dropped audio, and the per-file dropped-frame counts ride
    the manifest (``file_dropped``) so coverage/gap accounting stays
    accurate — the tail is real recorded time even if unanalyzed.

    All files must share one sample rate, which becomes the manifest
    ``fs`` unless an explicit ``fs`` is passed (then a mismatch raises).

    ``timestamps`` controls the UTC time axis: ``"auto"`` (default)
    parses per-file start times from the filenames using the built-in
    PAM conventions when ALL names parse (a mix raises; none parsing
    leaves a relative axis); any other string is an explicit
    strptime/regex pattern every file must match (see
    :mod:`repro_torch.meta.timestamps`); ``None``/``False`` disables parsing.
    When timestamps are present, overlapping files raise a loud
    ``ValueError`` from the manifest.
    """
    names = sorted(f for f in os.listdir(root)
                   if f.lower().endswith(".wav"))
    if not names:
        raise FileNotFoundError(f"no .wav files under {root!r}")
    counts, dropped, rates = [], [], set()
    for name in names:
        with wave.open(os.path.join(root, name), "rb") as w:
            if w.getnchannels() != 1 or w.getsampwidth() != 2:
                raise ValueError(
                    f"{name}: expected mono int16 PCM, got "
                    f"{w.getnchannels()} channel(s) x "
                    f"{w.getsampwidth()} byte(s)")
            rates.add(float(w.getframerate()))
            frames = w.getnframes()
            counts.append(frames // record_size)
            dropped.append(frames % record_size)
    if len(rates) > 1:
        raise ValueError(
            f"mixed sample rates under {root!r}: {sorted(rates)}")
    rate = rates.pop()
    if fs is not None and float(fs) != rate:
        raise ValueError(
            f"dataset under {root!r} is {rate} Hz, requested {fs} Hz")
    if any(dropped):
        clipped = [(n, d) for n, d in zip(names, dropped) if d]
        total_s = sum(d for _, d in clipped) / rate
        shown = ", ".join(f"{n} ({d / rate:.3f}s)"
                          for n, d in clipped[:4])
        more = f", +{len(clipped) - 4} more" if len(clipped) > 4 else ""
        warnings.warn(
            f"scan_dataset({root!r}): dropping {total_s:.3f}s of audio "
            f"in partial tail records across {len(clipped)} of "
            f"{len(names)} files ({shown}{more}); tails shorter than "
            f"record_size={record_size} frames are not analyzed but "
            f"still count toward coverage", RuntimeWarning,
            stacklevel=2)
    starts = None
    if timestamps not in (None, False):
        starts = timestamps_for(
            names, None if timestamps == "auto" else timestamps)
    return DatasetManifest.from_files(
        counts, record_size=record_size, fs=rate, file_names=names,
        seed=seed, file_starts=starts, file_dropped=dropped)


def _calibration_gains(m: DatasetManifest, calibration) -> np.ndarray | None:
    """Normalize a calibration spec to one float32 gain per file.

    Accepts an :class:`~repro_torch.meta.instrument.Instrument` (the gain is
    *derived* from the physical model — preferred), a scalar, or one
    gain per file.
    """
    if calibration is None:
        return None
    if isinstance(calibration, Instrument):
        calibration = calibration.gain
    g = np.asarray(calibration, np.float32)
    if g.ndim == 0:
        return np.full(m.n_files, g, np.float32)
    if g.shape != (m.n_files,):
        raise ValueError(
            f"calibration must be a scalar or one gain per file "
            f"({m.n_files}), got shape {g.shape}")
    return g


def _file_scales(m: DatasetManifest, calibration) -> np.ndarray:
    """Per-file float32 decode scales: PCM_DECODE_SCALE * gain, fused.

    One rounding happens here, once per file; every decode afterwards is
    a single multiply by this value — the same multiply the CUDA
    kernels perform on raw int16 payloads, which is why the two
    transports agree bitwise.
    """
    g = _calibration_gains(m, calibration)
    if g is None:
        return np.full(m.n_files, PCM_DECODE_SCALE, np.float32)
    return PCM_DECODE_SCALE * g


def sidecar_scales(m: DatasetManifest, scales: np.ndarray,
                   indices) -> np.ndarray:
    """Per-record decode-scale sidecar for a batch of global indices.

    Pure manifest arithmetic (a searchsorted over file offsets) — no IO,
    a few bytes per record next to the 2-byte-per-sample payload.
    Padding/invalid slots get the plain full-scale factor; their PCM is
    zero, so any finite scale decodes them to 0.0 like the float path.
    """
    idx = np.asarray(indices)
    out = np.full(idx.shape, PCM_DECODE_SCALE, np.float32)
    flat = idx.reshape(-1)
    valid = (flat >= 0) & (flat < m.n_records)
    if valid.any():
        fi, _ = m.locate_many(flat[valid])
        out.reshape(-1)[valid] = scales[fi]
    return out


class _HandleCache:
    """Bounded thread-safe LRU of open ``wave`` readers.

    Checkout-based: a handle is *removed* from the cache while a thread
    uses it (wave objects carry seek state), then returned.  Concurrent
    readers of the same file briefly hold independent handles; returning
    past capacity closes the least-recently-used idle handle.
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self.opens = 0                    # lifetime wave.open count
        self._lock = threading.Lock()
        self._idle: collections.OrderedDict[int, list] = \
            collections.OrderedDict()

    def checkout(self, file_idx: int, path: str):
        with self._lock:
            handles = self._idle.get(file_idx)
            if handles:
                h = handles.pop()
                if not handles:
                    del self._idle[file_idx]
                return h
            self.opens += 1
        return wave.open(path, "rb")

    def checkin(self, file_idx: int, handle) -> None:
        evicted = []
        with self._lock:
            self._idle.setdefault(file_idx, []).append(handle)
            self._idle.move_to_end(file_idx)
            while sum(len(v) for v in self._idle.values()) > self.capacity:
                oldest, handles = next(iter(self._idle.items()))
                evicted.append(handles.pop(0))
                if not handles:
                    del self._idle[oldest]
        for h in evicted:
            h.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, collections.OrderedDict()
        for handles in idle.values():
            for h in handles:
                h.close()


def _decode_pcm(raw: bytes, want_frames: int, path: str,
                at_record: int) -> np.ndarray:
    """int16 bytes -> ``<i2`` array, validating the frame count.

    ``readframes`` silently returns short at EOF; with variable-length
    files that would mean silently analyzing a zero-padded tail, so a
    short read is an error naming the file and offset instead.  The
    error is a :class:`~repro_torch.faults.errors.TruncatedRecordError` (a
    ValueError subclass): data-attributable, so the fault machinery
    quarantines the record under ``.tolerate(bad_records=N)`` instead
    of retrying a read that can never succeed.
    """
    pcm = np.frombuffer(raw, dtype="<i2")
    if pcm.size != want_frames:
        raise TruncatedRecordError(
            f"truncated read from {path!r}: wanted {want_frames} frames "
            f"starting at record {at_record}, got {pcm.size} — the file "
            f"is shorter than the manifest says (re-run scan_dataset?)",
            record=at_record)
    return pcm


class WavRecordReader:
    """reader(indices (s, c)) -> waveforms (s, c, record_size).

    One open + seek + read per record — the bitwise oracle the coalesced
    :class:`BlockReader` is tested against.  ``file_opens`` counts opens
    so the coalescing win is assertable, not just believed.

    ``raw=True`` skips the float conversion: payloads come back as
    ``<i2`` PCM and :meth:`scales_for` supplies the decode-scale sidecar.
    """

    def __init__(self, root: str, m: DatasetManifest, calibration=None,
                 raw: bool = False):
        self.root = root
        self.m = m
        self.raw = raw
        self.scales = _file_scales(m, calibration)
        self.dtype = np.dtype("<i2") if raw else np.dtype(np.float32)
        self.file_opens = 0

    def read_one(self, idx: int) -> np.ndarray:
        fi, ri = self.m.locate(int(idx))
        path = os.path.join(self.root, self.m.file_name(fi))
        self.file_opens += 1
        with wave.open(path, "rb") as w:
            w.setpos(ri * self.m.record_size)
            raw = w.readframes(self.m.record_size)
        pcm = _decode_pcm(raw, self.m.record_size, path, ri)
        if self.raw:
            return pcm
        return pcm.astype(np.float32) * self.scales[fi]

    def scales_for(self, indices) -> np.ndarray:
        """Per-record float32 decode-scale sidecar (see module doc)."""
        return sidecar_scales(self.m, self.scales, indices)

    def __call__(self, indices: np.ndarray) -> np.ndarray:
        flat = [self.read_one(i) if 0 <= i < self.m.n_records
                else np.zeros(self.m.record_size, self.dtype)
                for i in indices.reshape(-1)]
        return np.stack(flat).reshape(*indices.shape, self.m.record_size)


def files_touched(m: DatasetManifest, indices) -> np.ndarray:
    """Sorted unique file ids holding ``indices`` (out-of-range indices
    — a partitioned plan's padding — are ignored).

    The read-locality invariant of the sharded execution layer is
    stated in terms of this set: a worker slice's steps must only ever
    touch files inside its ``[file_lo, file_hi)`` footprint, so each
    process opens none of its peers' files.
    """
    flat = np.asarray(indices).reshape(-1).astype(np.int64)
    flat = flat[(flat >= 0) & (flat < m.n_records)]
    if not flat.size:
        return np.zeros(0, np.int64)
    fi, _ = m.locate_many(flat)
    return np.unique(fi)


class BlockReader:
    """Block-coalesced batch reader: same contract as
    :class:`WavRecordReader`, minimal file-system traffic.

    A ``fetch(indices)`` call sorts the requested records by (file,
    offset), merges contiguous runs into single ``readframes`` calls
    (with the shard plan's contiguous-chunk layout, a whole shard-step
    inside one file is ONE read), and keeps up to ``max_open_files``
    wav handles open across calls.  Thread-safe: a prefetching source
    over-decomposes steps and fetches sub-slices concurrently.

    ``raw=True`` returns ``<i2`` PCM with no float pass at all — the
    payload bytes go straight from ``readframes`` into the batch array —
    and :meth:`scales_for` supplies the decode-scale sidecar.
    """

    def __init__(self, root: str, m: DatasetManifest,
                 max_open_files: int = 8, calibration=None,
                 raw: bool = False):
        self.root = root
        self.m = m
        self.raw = raw
        self.scales = _file_scales(m, calibration)
        self.dtype = np.dtype("<i2") if raw else np.dtype(np.float32)
        self._cache = _HandleCache(max_open_files)
        self._stat_lock = threading.Lock()
        self.reads = 0                    # readframes calls (coalesced)
        self.records_read = 0

    @property
    def file_opens(self) -> int:
        return self._cache.opens

    def _read_run(self, fi: int, r0: int, n: int) -> np.ndarray:
        """Read ``n`` contiguous records of file ``fi`` from record
        ``r0`` — one seek + one readframes; returns ``<i2`` PCM."""
        rs = self.m.record_size
        path = os.path.join(self.root, self.m.file_name(fi))
        h = self._cache.checkout(fi, path)
        try:
            h.setpos(r0 * rs)
            raw = h.readframes(n * rs)
        finally:
            self._cache.checkin(fi, h)
        return _decode_pcm(raw, n * rs, path, r0)

    def scales_for(self, indices) -> np.ndarray:
        """Per-record float32 decode-scale sidecar (see module doc)."""
        return sidecar_scales(self.m, self.scales, indices)

    def fetch(self, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices)
        flat = idx.reshape(-1).astype(np.int64)
        rs = self.m.record_size
        out = np.zeros((flat.size, rs), self.dtype)
        valid = np.nonzero((flat >= 0) & (flat < self.m.n_records))[0]
        if valid.size:
            fi, ri = self.m.locate_many(flat[valid])
            order = np.lexsort((ri, fi))
            valid, fi, ri = valid[order], fi[order], ri[order]
            # a run breaks where the file changes or records skip
            brk = np.nonzero((np.diff(fi) != 0) | (np.diff(ri) != 1))[0] + 1
            starts = np.concatenate([[0], brk])
            ends = np.concatenate([brk, [valid.size]])
            for s, e in zip(starts, ends):
                f, n = int(fi[s]), int(e - s)
                block = self._read_run(f, int(ri[s]), n)
                if not self.raw:
                    block = block.astype(np.float32) * self.scales[f]
                out[valid[s:e]] = block.reshape(n, rs)
            with self._stat_lock:
                self.reads += len(starts)
                self.records_read += int(valid.size)
        return out.reshape(*idx.shape, rs)

    __call__ = fetch

    def stats(self) -> dict:
        with self._stat_lock:
            return {"file_opens": self.file_opens, "reads": self.reads,
                    "records_read": self.records_read}

    def close(self) -> None:
        self._cache.close()
