"""K6: threshold + compaction, frame SPL -> ragged event rows.

Devices cannot return ragged arrays, so detection emits the
count-prefixed fixed-capacity encoding:

  * ``counts`` — ``(batch,)`` int32, the TRUE number of qualifying
    events per record (not capped: ``counts > capacity`` flags
    overflow);
  * ``rows`` — ``(batch, capacity, 4)`` float32, the first
    ``min(count, capacity)`` events per record as ``(onset_frame,
    n_frames, peak_bin, peak_db)``; unused slots are zero.

A Schmitt trigger over the per-frame wideband SPL: a frame opens an
event when ``spl >= threshold_db`` and none is open; an open event
closes at the first frame with ``spl < threshold_db - hysteresis_db``
(its duration excludes that frame) or at the record end.  Events
shorter than ``min_len`` frames are dropped; ``peak_db`` is the largest
frame SPL in the event (the first frame wins ties) and ``peak_bin`` that
frame's argmax PSD bin.  Comparisons, selects and integer adds only, no
rounding, so the CUDA kernel, the plain version here and the reference
agree bit for bit.  Replaces the TPU kernel
``src/repro/kernels/events.py:137`` (``detect_events``).  The CUDA
kernel (``csrc/events.cu``) runs a block per record over chunks of the
trace, each thread a tile of frames: tile summaries of the trigger for
either entry state, a block scan of them, then each tile's events
emitted from its true entry state; the source says what bounds it on
the card and how the design answers.  The wrapper launches from a
launch plan built once per configuration and device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _build
from .common import LaunchCounter, check_cuda, launch

N_EVENT_COLS = 4          # onset_frame, n_frames, peak_bin, peak_db

LAUNCHES = LaunchCounter("detect_events")

# The CUDA kernel's layout (csrc/events.cu kTile, kMaxThreads x kTile):
# the frames a thread owns in a chunk, and the most frames a block
# stages at once.  The plan checks them against the built kernel; the
# kernel checks on the card place trace edges by them.
TILE_FRAMES = 15
CHUNK_FRAMES = 512 * TILE_FRAMES


def detect_events_plain(spl: torch.Tensor, peak_bin: torch.Tensor, *,
                        threshold_db: float, hysteresis_db: float,
                        min_len: int = 1, capacity: int = 16
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the reference's scan body, one step of
    ``torch.where`` over the ``(batch,)`` state per frame."""
    spl = spl.to(torch.float32)
    peak_bin = peak_bin.to(torch.int32)
    b, n_frames = spl.shape
    dev = spl.device
    thr = torch.tensor(np.float32(threshold_db), device=dev)
    lo = torch.tensor(np.float32(threshold_db) - np.float32(hysteresis_db),
                      device=dev)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]

    def emit(count, rows, qualify, start, dur, pk_bin, pk_db):
        row = torch.stack([start.to(torch.float32), dur.to(torch.float32),
                           pk_bin.to(torch.float32), pk_db], dim=-1)
        hot = qualify[:, None] & (slots == count[:, None])
        rows = torch.where(hot[:, :, None], row[:, None, :], rows)
        return count + qualify.to(torch.int32), rows

    in_ev = torch.zeros(b, dtype=torch.bool, device=dev)
    start = torch.zeros(b, dtype=torch.int32, device=dev)
    pk_db = torch.full((b,), -float("inf"), dtype=torch.float32, device=dev)
    pk_bin = torch.zeros(b, dtype=torch.int32, device=dev)
    count = torch.zeros(b, dtype=torch.int32, device=dev)
    rows = torch.zeros((b, capacity, N_EVENT_COLS), dtype=torch.float32,
                       device=dev)
    for f in range(n_frames):
        s, pb = spl[:, f], peak_bin[:, f]
        closing = in_ev & (s < lo)
        dur = f - start
        count, rows = emit(count, rows, closing & (dur >= min_len), start,
                           dur, pk_bin, pk_db)
        in_ev = in_ev & ~closing
        better = in_ev & (s > pk_db)
        pk_db = torch.where(better, s, pk_db)
        pk_bin = torch.where(better, pb, pk_bin)
        opening = ~in_ev & (s >= thr)
        start = torch.where(opening, f, start)
        pk_db = torch.where(opening, s, pk_db)
        pk_bin = torch.where(opening, pb, pk_bin)
        in_ev = in_ev | opening
    dur = n_frames - start
    return emit(count, rows, in_ev & (dur >= min_len), start, dur, pk_bin,
                pk_db)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a K6 launch needs that depends only on the configuration and
    the device: the entry point, once the kernel's shared-memory limit
    is raised on the device, and its trailing scalars."""
    fn: object
    tail: tuple         # (threshold, hysteresis, min_len, capacity)


@functools.lru_cache(maxsize=16)
def _plan(device: torch.device, threshold_db: float, hysteresis_db: float,
          min_len: int, capacity: int) -> _Plan:
    tile, chunk = ctypes.c_int(), ctypes.c_int()
    ip = ctypes.POINTER(ctypes.c_int)
    setup = _build.function("depam_detect_events_plan", ip, ip)
    with torch.cuda.device(device):
        err = setup(ctypes.byref(tile), ctypes.byref(chunk))
    _build.check(err, "detect_events plan")
    if (tile.value, chunk.value) != (TILE_FRAMES, CHUNK_FRAMES):
        raise RuntimeError(f"csrc/events.cu tiles {tile.value} frames in "
                           f"chunks of {chunk.value}; events.py says "
                           f"{TILE_FRAMES} and {CHUNK_FRAMES}")
    fn = _build.function("depam_detect_events", _build.P, _build.P,
                         _build.P, _build.P, _build.I, _build.I, _build.F,
                         _build.F, _build.I, _build.I, _build.P)
    # both knobs cross as float32, and the kernel rounds
    # f32(threshold) - f32(hysteresis) once, as the reference does
    return _Plan(fn=fn, tail=(float(np.float32(threshold_db)),
                              float(np.float32(hysteresis_db)),
                              int(min_len), int(capacity)))


def detect_events(spl: torch.Tensor, peak_bin: torch.Tensor, *,
                  threshold_db: float, hysteresis_db: float,
                  min_len: int = 1, capacity: int = 16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, F) float32 SPL + int32 peak bins -> ``(counts (B,) int32,
    rows (B, capacity, 4) float32)``."""
    if spl.shape != peak_bin.shape or spl.dim() != 2:
        raise ValueError(f"spl and peak_bin must be (B, F) of one shape, "
                         f"got {tuple(spl.shape)} and "
                         f"{tuple(peak_bin.shape)}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if spl.device.type == "cpu":
        return detect_events_plain(
            spl, peak_bin, threshold_db=threshold_db,
            hysteresis_db=hysteresis_db, min_len=min_len, capacity=capacity)
    check_cuda(spl, "spl", (torch.float32,), 2)
    check_cuda(peak_bin, "peak_bin", (torch.int32,), 2)
    spl = spl.contiguous()
    peak_bin = peak_bin.contiguous()
    n_rec, n_frames = spl.shape
    dev = spl.device
    plan = _plan(dev, threshold_db, hysteresis_db, min_len, capacity)
    counts = torch.empty((n_rec,), dtype=torch.int32, device=dev)
    rows = torch.empty((n_rec, capacity, N_EVENT_COLS), dtype=torch.float32,
                       device=dev)
    err = launch(dev, plan.fn, spl.data_ptr(), peak_bin.data_ptr(),
                 counts.data_ptr(), rows.data_ptr(), n_rec, n_frames,
                 *plan.tail)
    _build.check(err, "detect_events")
    LAUNCHES.hit()
    return counts, rows
