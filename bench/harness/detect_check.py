"""The detection cell's per-record numbers: the program's Welch PSD,
percentiles, events and impulsive metrics against the reference's
(``reference/detect_ref.py``) for one record.

Events are held to the reference's frame levels, not to the reference's
own event rows, so that a frame whose level lies a hair from a threshold
may fall either side of it: the candidate's events say, frame by frame,
whether the Schmitt trigger opened, stayed open, closed or stayed
closed, and ``events_db`` is the largest level by which the reference's
frame levels contradict one of those decisions, or the peak level or
peak bin of an event.  A lost, moved or split event contradicts a frame
by as much as a strike stands over the noise; ``events_mismatch`` counts
events that have no counterpart at all, a doubled one among them.

Numbers (all "smaller is closer"):

  * ``welch_rel``       largest relative error of a Welch PSD bin;
  * ``pct_db``          largest percentile error, dB;
  * ``events_mismatch`` events of either side that overlap no event of
                        the other (paired one to one, in onset order);
  * ``events_db``       as above, dB;
  * ``impulsive_rel``   the impulsive metrics of the candidate's events
                        against the reference's over the same samples
                        (SEL and peak compared as powers, kurtosis and
                        rise time relative).
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("welch_rel", "pct_db", "events_mismatch", "events_db",
           "impulsive_rel")


def decision_db(rows: list[tuple], spl: np.ndarray, threshold_db: float,
                hysteresis_db: float) -> float:
    """The largest level, dB, by which ``spl`` contradicts the trigger's
    decision at a frame that ``rows`` imply: open (at or above the
    threshold), stay closed (below it), stay open (at or above the
    closing level, ``threshold - hysteresis``) or close (below it).
    Every opened event is kept, so the rows give each frame's state
    (an event lasts one frame or more)."""
    now = np.zeros(len(spl), bool)
    for on, d, _, _ in rows:
        now[on:on + d] = True
    before = np.concatenate([[False], now[:-1]])
    lo = threshold_db - hysteresis_db
    v = np.where(before, np.where(now, lo - spl, spl - lo),
                 np.where(now, threshold_db - spl, spl - threshold_db))
    return float(max(0.0, v.max(initial=0.0)))


def _peak_db(row: tuple, spl: np.ndarray, fdb: np.ndarray) -> float:
    """How far the reference is from ``row``'s peak: its level against
    the event's loudest frame, and the smallest move of the levels that
    would make the row's bin the loudest of a loudest frame."""
    on, d, b, level = row
    seg = spl[on:on + d]
    top = seg.max()
    bin_db = min(max(top - seg[j], fdb[on + j].max() - fdb[on + j, b])
                 for j in range(d))
    return max(abs(level - top), bin_db)


def mismatch(cand: list[tuple], ref: list[tuple]) -> int:
    """Events of either list that overlap no event of the other, each
    candidate paired with the first unpaired reference event it
    overlaps."""
    free = list(ref)
    lone = 0
    for on, d, _, _ in cand:
        hit = next((r for r in free
                    if r[0] < on + d and on < r[0] + r[1]), None)
        if hit is None:
            lone += 1
        else:
            free.remove(hit)
    return lone + len(free)


def impulsive_rel(cand: np.ndarray, ref: np.ndarray) -> float:
    a, b = np.asarray(cand, np.float64), np.asarray(ref, np.float64)
    if a.shape != b.shape:
        return float("nan")
    if not len(a):
        return 0.0
    rel = [np.abs(10.0 ** ((a[:, 0] - b[:, 0]) / 10.0) - 1.0),
           np.abs(10.0 ** ((a[:, 1] - b[:, 1]) / 10.0) - 1.0),
           np.abs(a[:, 2] - b[:, 2]) / np.abs(b[:, 2]),
           np.abs(a[:, 3] - b[:, 3]) / np.maximum(np.abs(b[:, 3]), 1e-12)]
    return float(np.max(rel))


def event_rows(rows) -> list[tuple]:
    """Event rows ``(onset, frames, peak bin, peak dB)`` as the sink or
    the reference gives them, with whole numbers where they are."""
    return [(int(r[0]), int(r[1]), int(r[2]), float(r[3])) for r in rows]


def record_numbers(cand: dict, ref: dict, threshold_db: float,
                   hysteresis_db: float, min_len: int) -> dict:
    """One record's numbers.  ``cand``: ``welch``, ``pct``, ``events``
    (rows), ``impulsive`` (the rows' metrics); ``ref``: ``welch``,
    ``pct``, ``spl`` (frame levels), ``fdb`` (frames, bins), ``events``
    (its own rows) and ``impulsive`` (its metrics over the candidate's
    rows)."""
    if min_len != 1:
        raise ValueError("the frame-by-frame event check needs "
                         "event_min_len 1")
    ev_c, ev_r = event_rows(cand["events"]), event_rows(ref["events"])
    spl, fdb = ref["spl"], ref["fdb"]
    try:
        ev_db = max([decision_db(ev_c, spl, threshold_db, hysteresis_db)]
                    + [_peak_db(r, spl, fdb) for r in ev_c])
    except (IndexError, ValueError):    # rows outside the record
        ev_db = float("nan")
    wc = np.asarray(cand["welch"], np.float64)
    return {
        "welch_rel": float(np.max(np.abs(wc - ref["welch"]) / ref["welch"])),
        "pct_db": float(np.max(np.abs(np.asarray(cand["pct"], np.float64)
                                      - ref["pct"]))),
        "events_mismatch": float(mismatch(ev_c, ev_r)),
        "events_db": float(ev_db),
        "impulsive_rel": impulsive_rel(cand["impulsive"], ref["impulsive"]),
    }
