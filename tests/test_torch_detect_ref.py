"""The port's detection path against the benchmark's plain reference
(``bench/reference/detect_ref.py``, float64 PyTorch that imports nothing
of the port) on the CPU, on seeded records of the benchmark's detection
content (``bench/harness/strikes.py``: noise and a tone, pile-driving
strikes on half the records) at a small size: the spectrum percentiles
and the events with their impulsive metrics of every record, and the SPD
of every window, over windows of 5 records that steps of 3 straddle,
streamed to a callback as they close.

The port computes in float32 and the reference in float64; each limit
is a few times the largest difference the seeds give.  Events are held
to the reference's frame levels (``bench/harness/detect_check.py``), so
a frame a hair from a threshold may fall either side of it."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.sources import ReaderSource
from repro_torch.core.manifest import DatasetManifest

BENCH = Path(__file__).resolve().parents[1] / "bench"
sys.path.insert(0, str(BENCH))

from harness import check, detect_check, strikes  # noqa: E402
from reference import depam_ref as R  # noqa: E402
from reference import detect_ref as D  # noqa: E402

WINDOW, CHUNK, N_RECORDS = 5, 3, 17


def _cfg() -> dict:
    """The benchmark's set-2 configuration at its tiny sizes."""
    cfg = json.loads((BENCH / "configs" / "depam_set2.json").read_text())
    cfg.update(json.loads(
        (BENCH / "tests" / "tiny" / "configs" / "depam_set2.json")
        .read_text()))
    return cfg


@pytest.fixture(scope="module", params=[3, 2 ** 31 + 11])
def run(request):
    from harness import runner
    cfg = _cfg()
    p = runner.params(cfg)
    seed = request.param
    pool, scales, struck = strikes.strike_pool(cfg, seed, 12,
                                               torch.device("cpu"))
    n = len(pool)
    m = DatasetManifest(n_files=1, records_per_file=N_RECORDS,
                        record_size=p.record_size, fs=p.fs)
    flushed = {}

    def on_windows(name, start, values):
        for w, row in enumerate(values, start):
            flushed.setdefault((name, w), []).append(np.array(row))

    src = ReaderSource(lambda idx: pool[np.asarray(idx) % n],
                       payload_dtype="int16",
                       scales=lambda idx: scales[np.asarray(idx) % n])
    res = (api.job(m, p).features("welch", "percentiles", "spd")
           .events(impulsive=True).window(records=WINDOW).source(src)
           .payload("int16").chunk(CHUNK).device("cpu").run())
    streamed = (api.job(m, p).features("welch", "percentiles", "spd")
                .events(impulsive=True).window(records=WINDOW).source(src)
                .payload("int16").chunk(CHUNK).device("cpu")
                .to(api.CallbackSink(lambda *a: None,
                                     on_windows=on_windows))
                .async_io(depth=0, inflight=2).run())
    rp = check.params(cfg)
    ref = []
    for i in range(N_RECORDS):
        x = R.decode(pool[i % n], scales[i % n], "cpu")
        psd, fdb = D.frame_db(x, rp)
        spl = D.frame_spl(psd, rp).numpy()
        ev = D.events(spl, torch.argmax(psd, -1).numpy(),
                      p.event_threshold_db, p.event_hysteresis_db,
                      p.event_min_len)
        ref.append({"welch": psd.mean(0).numpy(),
                    "pct": D.percentiles(fdb).numpy(),
                    "counts": D.spd_counts(fdb), "events": ev,
                    "spl": spl, "fdb": fdb.numpy(), "x": x})
    return res, streamed, flushed, ref, struck


def test_percentiles_and_welch(run):
    res, _, _, ref, _ = run
    pct = np.stack([r["pct"] for r in ref])
    welch = np.stack([r["welch"] for r in ref])
    assert np.max(np.abs(res["percentiles"] - pct)) < 2e-3
    assert np.max(np.abs(res["welch"] - welch) / welch) < 2e-5


def test_spd_of_every_window(run):
    res, streamed, flushed, ref, _ = run
    spd = res.windows["spd"]
    assert spd.shape[0] == -(-N_RECORDS // WINDOW)
    for w in range(spd.shape[0]):
        counts = sum(r["counts"] for r in ref[w * WINDOW:(w + 1) * WINDOW])
        want = D.spd_density(counts).numpy()
        share = np.abs(spd[w] - want).sum(-1) * D.SPD_DB_STEP / 2
        assert share.mean() < 1e-4, (w, share.mean())
        # each window reaches the streaming sink once, with the bits of
        # the job-end recompute
        assert len(flushed[("spd", w)]) == 1
        assert np.array_equal(flushed[("spd", w)][0], spd[w])
    assert np.array_equal(streamed.windows["spd"], spd)


def test_events_and_impulsive_metrics(run):
    res, _, _, ref, struck = run
    ev, imp = res.events["events"], res.events["impulsive"]
    n = len(ref)
    assert any(len(r["events"]) for r in ref)
    from harness import runner
    p, rp = runner.params(_cfg()), check.params(_cfg())
    for i in range(n):
        got = ev.record(i)
        assert ev.counts[i] == len(got)
        num = detect_check.record_numbers(
            {"welch": ref[i]["welch"], "pct": ref[i]["pct"], "events": got,
             "impulsive": imp.record(i)},
            dict(ref[i], impulsive=D.impulsive(
                ref[i]["x"], detect_check.event_rows(got), rp)),
            p.event_threshold_db, p.event_hysteresis_db, p.event_min_len)
        assert num["events_mismatch"] == 0, i
        assert num["events_db"] < 1e-4, (i, num)
        assert num["impulsive_rel"] < 1e-5, (i, num)
    # strike-free records detect nothing
    quiet = [i for i in range(n) if i % 12 not in set(struck.tolist())]
    assert quiet and all(ev.counts[i] == 0 for i in quiet)


def test_event_check_holds_events_to_the_frame_levels(run):
    """The cell's event check passes the reference's own events and
    fails a lost, a moved and a doubled one by the level of the frame
    that decides it."""
    _, _, _, ref, _ = run
    from harness import runner
    p = runner.params(_cfg())
    r = next(r for r in ref if r["events"])
    thr, hy = p.event_threshold_db, p.event_hysteresis_db

    def numbers(rows):
        ones = np.ones((len(rows), 4))
        cand = {"welch": r["welch"], "pct": r["pct"], "events": rows,
                "impulsive": ones}
        return detect_check.record_numbers(
            cand, dict(r, impulsive=ones), thr, hy, 1)

    ev = r["events"]
    on, d, b, level = ev[0]
    loudest = max(r["spl"][on:on + d]) - thr
    assert numbers(ev)["events_db"] == 0.0
    assert numbers(ev)["events_mismatch"] == 0
    lost = numbers(ev[1:])
    assert lost["events_mismatch"] == 1
    assert lost["events_db"] == pytest.approx(loudest)
    step = 1 if on + d < len(r["spl"]) else -1
    moved = numbers([(on + step, d, b, level)] + list(ev[1:]))
    # the frame that opened it now stays closed, or the one before it,
    # below the threshold, now opens it
    decides = r["spl"][on] - thr if step > 0 else thr - r["spl"][on - 1]
    assert moved["events_db"] >= decides > 0
    doubled = numbers([ev[0]] + list(ev))
    assert doubled["events_mismatch"] == 1
