"""The port's multi-tenant serving layer on the CPU (``.device("cpu")``).

The cases of the reference's ``tests/test_serve.py``: concurrent tenants
bitwise equal to sequential runs (fresh and resumed, mixed payload
transports, ragged event logs), scheduler fairness bounds, compile-cache
accounting, ``LiveSource`` ring semantics (backpressure, graceful end of
stream, mid-stream resume), and the engine's resource-release
guarantees.  Beside them, the port's service against the reference's on
the same tenants (results within the job tolerances, event onset,
duration and peak bin exact; the same compile-cache hits and misses;
the same scheduler picks), and on the card (``cuda`` marker) a
background-mode drain and the device memory after a drain.
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import serve as jserve
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro_torch import api
from repro_torch import serve as tserve
from repro_torch.api.sinks import AsyncSink, MemorySink, Sink
from repro_torch.api.sources import PrefetchSource, Source
from repro_torch.core.manifest import DatasetManifest, plan
from repro_torch.core.params import DepamParams
from repro_torch.data.wavio import write_dataset
from repro_torch.serve import (DeficitRoundRobin, LiveSource, RingOverrun,
                               RoundRobin, SoundscapeService)

PKW = dict(nfft=256, window_size=256, window_overlap=128,
           record_size_sec=0.25)
P = DepamParams(**PKW)
M = DatasetManifest(n_files=3, records_per_file=4,
                    record_size=P.record_size, fs=P.fs, seed=7)
FEATS = ("welch", "spl")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    write_dataset(root, M)
    return root


def synth_job(**kw):
    return api.job(M, P).features(*FEATS).chunk(4).device("cpu")


def wav_job(root, payload=None):
    j = (api.job(M, P).features(*FEATS).chunk(4)
         .source(api.WavSource(root)).device("cpu"))
    return j if payload is None else j.payload(payload)


def event_job(root):
    """Ragged tenant: events + impulsive over the wav dataset, tuned so
    the 0.05-amplitude noise floor (~-26 dB frame SPL) actually fires
    and overflows the per-record capacity."""
    return (wav_job(root)
            .events(-25.5, hysteresis_db=0.5, capacity=4,
                    impulsive=True))


def assert_bitwise(a, b):
    """Two JobResults agree bit for bit across all four namespaces
    (dense features, epoch, windows, and ragged event logs)."""
    for da, db in ((a.features or {}, b.features or {}),
                   (a.epoch, b.epoch), (a.windows, b.windows)):
        assert sorted(da) == sorted(db)
        for k in da:
            assert np.array_equal(np.asarray(da[k]), np.asarray(db[k])), k
    ea, eb = a.events or {}, b.events or {}
    assert sorted(ea) == sorted(eb)
    for k in ea:
        assert np.array_equal(ea[k].counts, eb[k].counts), k
        assert ea[k].rows.shape == eb[k].rows.shape, k
        assert np.array_equal(ea[k].rows, eb[k].rows), k


class TestSchedulers:
    def test_round_robin_cycles(self):
        rr = RoundRobin()
        for t in "abc":
            rr.add(t)
        picks = [rr.pick(["a", "b", "c"]) for _ in range(6)]
        assert picks == ["a", "b", "c", "a", "b", "c"]

    def test_round_robin_skips_blocked_without_losing_place(self):
        rr = RoundRobin()
        for t in "abc":
            rr.add(t)
        assert rr.pick(["a", "b", "c"]) == "a"
        # b blocked on its live ring: turn passes to c, and when b is
        # runnable again it is next, not pushed to the back forever
        assert rr.pick(["a", "c"]) == "c"
        assert rr.pick(["a", "b", "c"]) == "a"
        assert rr.pick(["a", "b", "c"]) == "b"

    def test_deficit_weights_shape_the_pick_sequence(self):
        drr = DeficitRoundRobin()
        drr.add("heavy", weight=2.0)
        drr.add("light", weight=1.0)
        picks = []
        for _ in range(6):
            t = drr.pick(["heavy", "light"])
            drr.charge(t, 1)
            picks.append(t)
        # per replenish round: 2 heavy turns to 1 light turn
        assert picks == ["heavy", "heavy", "light",
                         "heavy", "heavy", "light"]

    def test_blocked_tenant_keeps_its_credit(self):
        drr = DeficitRoundRobin()
        drr.add("a")
        drr.add("b")
        assert drr.pick(["a", "b"]) == "a"
        drr.charge("a", 1)
        # a starved for a while: b runs alone and burns credit
        for _ in range(3):
            drr.charge(drr.pick(["b"]), 1)
        # back runnable, a's earned share catches it up first
        assert drr.pick(["a", "b"]) == "a"


class TestServiceBitwise:
    """The acceptance contract: concurrent tenants over one device are
    bitwise-identical to running each job sequentially alone."""

    def test_mixed_tenants_match_sequential(self, dataset):
        """synth + wav-float32 + wav-int16 tenants in one service."""
        jobs = {"synth": synth_job(),
                "wav32": wav_job(dataset),
                "wav16": wav_job(dataset, payload="int16")}
        svc = SoundscapeService(quantum=2)
        handles = {n: j.submit(svc, name=n) for n, j in jobs.items()}
        svc.run(timeout=600)
        for name in jobs:
            seq = {"synth": synth_job(),
                   "wav32": wav_job(dataset),
                   "wav16": wav_job(dataset, payload="int16")}[name].run()
            assert_bitwise(handles[name].result(), seq)

    def test_resumed_tenants_match_sequential(self, dataset, tmp_path):
        """Crash two store-backed tenants mid-job, resume them
        concurrently through a second service: stores + epoch outputs
        bitwise-equal to uninterrupted sequential runs."""
        da, db = str(tmp_path / "a"), str(tmp_path / "b")
        svc = SoundscapeService()
        synth_job().to(da).limit(1).submit(svc, name="a")
        wav_job(dataset).to(db).limit(1).submit(svc, name="b")
        svc.run(timeout=600)

        svc2 = SoundscapeService()
        ha = synth_job().to(da).submit(svc2, name="a")
        hb = wav_job(dataset).to(db).submit(svc2, name="b")
        svc2.run(timeout=600)
        assert_bitwise(ha.result(), synth_job().run())
        assert_bitwise(hb.result(), wav_job(dataset).run())

    def test_event_tenant_matches_sequential(self, dataset):
        """A ragged events+impulsive tenant next to dense tenants: the
        interleaved event logs (true counts AND kept rows) are
        bitwise-identical to its solo run."""
        svc = SoundscapeService(quantum=2)
        he = event_job(dataset).submit(svc, name="ev")
        hd = synth_job().submit(svc, name="dense")
        svc.run(timeout=600)
        res = he.result()
        assert res.events["events"].n_events > 0
        assert res.events["events"].overflow.any()
        assert_bitwise(res, event_job(dataset).run())
        assert_bitwise(hd.result(), synth_job().run())

    def test_resumed_event_tenant_matches_sequential(self, dataset,
                                                     tmp_path):
        """Crash a store-backed events tenant mid-job, resume it
        concurrently with a dense tenant: the event log's row cursor
        picks up exactly where the commit left it — no duplicated or
        dropped rows — and the final log is bitwise-equal to an
        uninterrupted solo run."""
        d = str(tmp_path / "ev")
        svc = SoundscapeService()
        event_job(dataset).to(d).limit(1).submit(svc, name="ev")
        svc.run(timeout=600)

        svc2 = SoundscapeService()
        he = event_job(dataset).to(d).submit(svc2, name="ev")
        hd = synth_job().submit(svc2, name="dense")
        svc2.run(timeout=600)
        assert_bitwise(he.result(), event_job(dataset).run())
        assert_bitwise(hd.result(), synth_job().run())

    def test_fairness_bound(self):
        """Equal always-runnable tenants: at every prefix of the turn
        trace no tenant is more than one turn ahead of another."""
        svc = SoundscapeService(quantum=1)
        names = [f"t{i}" for i in range(3)]
        for n in names:
            synth_job().submit(svc, name=n)
        svc.run(timeout=600)
        counts = dict.fromkeys(names, 0)
        for name, _ in svc.trace:
            counts[name] += 1
            assert max(counts.values()) - min(counts.values()) <= 1, \
                svc.trace

    def test_compile_cache_accounting(self, dataset):
        """Same-config tenants share one step function (>= 1 hit); the
        wav tenants build their own, since they differ from the synth
        tenants by device synthesis.  The step key holds no payload
        transport, so the float32 and int16 wav tenants share one."""
        svc = SoundscapeService()
        for n in ("a", "b"):
            synth_job().submit(svc, name=n)
        wav_job(dataset, payload="int16").submit(svc, name="c")
        wav_job(dataset).submit(svc, name="d")
        svc.run(timeout=600)
        cs = svc.stats()["compile"]
        assert cs["step"]["hits"] >= 2
        assert cs["step"]["entries"] == 2      # synth vs wav
        assert cs["reduce"]["hits"] >= 1
        assert cs["step"]["hits"] + cs["step"]["misses"] >= 4

    def test_failed_tenant_is_isolated(self):
        class Boom(Source):
            def __init__(self):
                self.closed = False

            def fetch(self, indices):
                raise RuntimeError("acquisition died")

            def close(self):
                self.closed = True

        boom = Boom()
        svc = SoundscapeService()
        bad = synth_job().source(boom).submit(svc, name="bad")
        good = synth_job().submit(svc, name="good")
        svc.run(timeout=600)
        assert bad.state == "failed"
        with pytest.raises(RuntimeError, match="failed"):
            bad.result()
        assert boom.closed                    # failed tenant released
        assert_bitwise(good.result(), synth_job().run())

    def test_background_service_submit_and_result(self):
        svc = SoundscapeService().start()
        try:
            h = synth_job().submit(svc, name="bg")
            res = h.result(timeout=600)
            assert res.n_records == M.n_records
            # one driver thread per service: a blocking run() beside
            # the background thread is refused
            with pytest.raises(RuntimeError, match="one thread"):
                svc.run()
        finally:
            svc.stop()


class TestLiveSource:
    def rec(self, n, seed=0):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((n, P.record_size)).astype(np.float32)

    def test_backpressure_blocks_then_raises(self):
        src = LiveSource(record_size=4, capacity=2)
        src.push(np.zeros(4, np.float32))
        src.push(np.zeros(4, np.float32))
        with pytest.raises(RingOverrun, match="ring full"):
            src.push(np.zeros(4, np.float32), timeout=0.05)
        src.fetch(np.array([0]))              # consumer frees a slot
        src.push(np.zeros(4, np.float32))     # now admitted

    def test_close_wakes_blocked_producer(self):
        src = LiveSource(record_size=4, capacity=1)
        src.push(np.zeros(4, np.float32))
        err = []

        def producer():
            try:
                src.push(np.ones(4, np.float32), timeout=30)
            except RuntimeError as e:
                err.append(e)

        th = threading.Thread(target=producer)
        th.start()
        time.sleep(0.05)
        src.close()
        th.join(timeout=5)
        assert not th.is_alive()
        assert err and "closed" in str(err[0])

    def test_poll_and_fetch_timeout(self):
        src = LiveSource(record_size=4, capacity=4, fetch_timeout=0.05)
        assert src.poll(np.array([0])) == "pending"
        src.push(np.zeros(4, np.float32))
        assert src.poll(np.array([0])) == "ready"
        with pytest.raises(TimeoutError, match="starved"):
            src.fetch(np.array([0, 1]))

    def test_push_after_end_raises(self):
        src = LiveSource(record_size=4, capacity=4)
        src.end()
        with pytest.raises(RuntimeError, match="closed"):
            src.push(np.zeros(4, np.float32))

    def test_eos_partial_stream_matches_truncated_reference(self):
        """End the stream after 9 of 12 manifest records: the job
        finishes gracefully over what arrived — per-record features,
        epoch aggregates, and windowed reductions all bitwise-equal to
        a batch job over just those records."""
        recs = self.rec(9, seed=3)
        src = LiveSource(record_size=P.record_size, capacity=16)
        svc = SoundscapeService()
        h = (api.job(M, P).features("welch", "ltsa").window(records=4)
             .chunk(4).source(src).device("cpu").submit(svc, name="live"))
        th = threading.Thread(target=src.feed, args=(recs,))
        th.start()
        svc.run(timeout=600)
        th.join()
        res = h.result()
        assert res.n_records == 9             # delivered, not manifest

        m9 = DatasetManifest.from_files(
            (4, 4, 1), record_size=P.record_size, fs=P.fs, seed=7)

        def reader(idx):
            flat = np.clip(idx.reshape(-1), 0, 8)
            return recs[flat].reshape(*idx.shape, -1)

        ref = (api.job(m9, P).features("welch", "ltsa").window(records=4)
               .chunk(4).source(reader).device("cpu").run())
        assert np.array_equal(res["welch"][:9], ref["welch"][:9])
        assert np.array_equal(res["mean_welch"], ref["mean_welch"])
        assert np.array_equal(res["ltsa"], ref["ltsa"])

    def test_mid_stream_resume_is_bitwise(self, tmp_path):
        """Crash a live tenant after one committed step; reconstruct
        the stream from the committed cursor and re-feed: the resumed
        accumulation equals an uninterrupted run bitwise."""
        d = str(tmp_path / "store")
        recs = self.rec(M.n_records, seed=5)
        src = LiveSource(record_size=P.record_size, capacity=16)
        svc = SoundscapeService()
        h = (api.job(M, P).features(*FEATS).chunk(4).source(src)
             .device("cpu").to(d).limit(1).submit(svc, name="crash"))
        th = threading.Thread(target=src.feed, args=(recs[:4],),
                              kwargs={"end": False})
        th.start()
        svc.run(timeout=600)
        th.join()
        src.close()
        assert h.records_done == 4

        resumed = api.job(M, P).features(*FEATS).chunk(4).to(d) \
            .device("cpu")
        step = resumed.resume_step()
        start = step * resumed._plan().records_per_step
        assert start == 4
        src2 = LiveSource(record_size=P.record_size, capacity=16,
                          start=start)
        svc2 = SoundscapeService()
        h2 = resumed.source(src2).submit(svc2, name="resume")
        th2 = threading.Thread(target=src2.feed, args=(recs[start:],))
        th2.start()
        svc2.run(timeout=600)
        th2.join()

        def reader(idx):
            flat = idx.reshape(-1) % M.n_records
            return recs[flat].reshape(*idx.shape, -1)

        ref = (api.job(M, P).features(*FEATS).chunk(4).source(reader)
               .device("cpu").run())
        out = h2.result()
        for name in FEATS:
            assert np.array_equal(np.asarray(out[name]), ref[name]), name
        assert np.array_equal(out["mean_welch"], ref["mean_welch"])

    def test_fetch_before_stream_start_raises(self):
        src = LiveSource(record_size=4, capacity=4, start=8)
        with pytest.raises(ValueError, match="before the stream start"):
            src.fetch(np.array([2]))


class TestResourceRelease:
    """The engine releases sources and sinks on ANY exit path."""

    class TrackingSource(Source):
        def __init__(self, fail_at_step=None):
            self.closed = False
            self.calls = 0
            self.fail_at_step = fail_at_step

        def fetch(self, indices):
            self.calls += 1
            if self.fail_at_step is not None \
                    and self.calls > self.fail_at_step:
                raise RuntimeError("mid-stream read failure")
            flat = indices.reshape(-1)
            out = np.zeros((flat.size, P.record_size), np.float32)
            return out.reshape(*indices.shape, P.record_size)

        def close(self):
            self.closed = True

    class TrackingSink(MemorySink):
        def __init__(self, fail_on_open=False):
            super().__init__()
            self.closed = False
            self.fail_on_open = fail_on_open

        def open(self, m, p, shapes, plan):
            if self.fail_on_open:
                raise RuntimeError("store unavailable")
            super().open(m, p, shapes, plan)

        def close(self):
            self.closed = True

    def test_mid_stream_failure_closes_source_and_sink(self):
        src = self.TrackingSource(fail_at_step=1)
        sink = self.TrackingSink()
        with pytest.raises(RuntimeError, match="mid-stream"):
            (api.job(M, P).features(*FEATS).chunk(4).device("cpu")
             .source(src).to(sink).run())
        assert src.closed
        assert sink.closed

    def test_sink_open_failure_still_closes_source(self):
        src = self.TrackingSource()
        sink = self.TrackingSink(fail_on_open=True)
        with pytest.raises(RuntimeError, match="store unavailable"):
            (api.job(M, P).features(*FEATS).chunk(4).device("cpu")
             .source(src).to(sink).run())
        assert src.closed
        assert sink.closed

    def test_abandoned_prefetch_leaves_no_loader_threads(self):
        def slow_reader(idx):
            time.sleep(0.02)
            flat = idx.reshape(-1)
            return np.zeros((flat.size, P.record_size), np.float32) \
                .reshape(*idx.shape, P.record_size)

        src = PrefetchSource(slow_reader, depth=2).bind(M, P)
        pl = plan(M, 1, 4)
        gen = src.stream(pl, 0, pl.n_steps)
        next(gen)                     # consume one step, abandon the rest
        del gen
        src.close()
        orphans = [t.name for t in threading.enumerate()
                   if t.name.startswith("SpecLoader")]
        assert orphans == []

    def test_async_sink_close_releases_after_worker_failure(self):
        class FailingSink(Sink):
            wants_commit = False

            def __init__(self):
                self.closed = False

            def write(self, step, indices, values):
                raise RuntimeError("disk full")

            def close(self):
                self.closed = True

        a = AsyncSink(FailingSink(), queue_size=2)
        a.open(M, P, {"welch": (P.n_bins,)}, plan(M, 1, 4))
        a.write(0, np.array([0]), {"welch": np.zeros((1, P.n_bins),
                                                     np.float32)})
        with pytest.raises(RuntimeError, match="AsyncSink worker"):
            a.close()
        # the sticky error did NOT leak the worker or the inner sink
        assert a.inner.closed
        assert a._worker is None
        assert [t for t in threading.enumerate()
                if t.name.startswith("AsyncSink")] == []

    def test_closed_stepper_holds_no_device_state(self):
        """A finished tenant's stepper, still referenced by its handle,
        has dropped its carry, staging slots and step functions."""
        svc = SoundscapeService()
        h = synth_job().async_io().submit(svc, name="a")
        svc.run(timeout=600)
        st = h.stepper
        assert st._agg_state is None and st._step_fns is None
        assert st._h2d == [] and st._d2h is None
        assert h.result().n_records == M.n_records


# -- against the reference service ----------------------------------------

# frame SPL of _gen's corpus: noise about -50 dB, bursts -30 to -42 dB
THRESHOLD_DB, HYSTERESIS_DB = -46.0, 1.5
REL, DB = 1e-4, 1e-3        # the job tolerances of tests/test_torch_job.py
JP = JParams(**PKW)
JM = JManifest(n_files=3, records_per_file=4, record_size=JP.record_size,
               fs=JP.fs, seed=7)


def _gen(fi, n):
    """Quiet noise plus a Hann-windowed 1 kHz burst in two of every three
    records, 20-30 dB over the noise and far from the threshold, so both
    packages detect the same events."""
    rng = np.random.default_rng([7, fi])
    x = rng.standard_normal(n) * 0.003
    rs = P.record_size
    for r in range(n // rs):
        if (r + fi) % 3 == 2:
            continue
        pos = r * rs + (rs // 3 if r % 2 else rs // 8)
        x[pos:pos + 600] += 0.05 * np.hanning(600) * np.sin(
            2 * np.pi * 1000.0 * np.arange(600) / P.fs)
    return x


@pytest.fixture(scope="module")
def burst_wavs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("burst_wavs"))
    write_dataset(root, M, gen=_gen)
    return root


def _mixed(a, serve, m, p, root, recs, out, extra=lambda j: j):
    """The mixed tenants of one package (``a``, ``serve``): batch (wav),
    event (wav, events + impulsive), resumed (wav, 1 step committed by
    an earlier run), live (9 of 12 records, then end()); every tenant
    writes a store under ``out``.  Returns {name: JobResult} and the
    compile-cache stats."""

    def wav(feats=FEATS):
        return extra(a.job(m, p).features(*feats).chunk(4)
                     .source(a.WavSource(root)))

    def events():
        return wav().events(THRESHOLD_DB, hysteresis_db=HYSTERESIS_DB,
                            impulsive=True)

    wav().to(f"{out}/resumed").limit(1).run()
    src = serve.LiveSource(record_size=p.record_size, capacity=8)
    svc = serve.SoundscapeService(scheduler=serve.DeficitRoundRobin(),
                                  quantum=1)
    handles = {
        "batch": wav().to(f"{out}/batch").submit(svc, name="batch"),
        "event": events().to(f"{out}/event").submit(svc, name="event",
                                                    weight=2.0),
        "resumed": wav().to(f"{out}/resumed").submit(svc, name="resumed"),
        "live": extra(a.job(m, p).features(*FEATS).chunk(4).source(src))
        .to(f"{out}/live").submit(svc, name="live")}
    th = threading.Thread(target=src.feed, args=(recs,))
    th.start()
    svc.run(timeout=600)
    th.join()
    return ({n: h.result() for n, h in handles.items()},
            svc.stats()["compile"])


def test_mixed_tenants_match_the_reference_service(burst_wavs, tmp_path):
    recs = np.random.default_rng(11).standard_normal(
        (9, P.record_size)).astype(np.float32)
    got, port_cs = _mixed(api, tserve, M, P, burst_wavs, recs,
                          str(tmp_path / "t"), lambda j: j.device("cpu"))
    want, ref_cs = _mixed(japi, jserve, JM, JP, burst_wavs, recs,
                          str(tmp_path / "r"))
    assert port_cs == ref_cs
    assert got["live"].n_records == want["live"].n_records == 9
    for name in got:
        g, w = got[name], want[name]
        for k in ("welch", "mean_welch"):
            a, b = np.asarray(g[k], np.float64), np.asarray(w[k])
            if name == "live":
                a, b = a[:9], b[:9]
            assert np.max(np.abs(a - b) / np.abs(b)) < REL, (name, k)
        spl_g, spl_w = np.asarray(g["spl"]), np.asarray(w["spl"])
        if name == "live":
            spl_g, spl_w = spl_g[:9], spl_w[:9]
        assert np.max(np.abs(spl_g - spl_w)) < DB, name
    ge, we = got["event"].events, want["event"].events
    assert ge["events"].n_events == we["events"].n_events > 0
    for k in ("events", "impulsive"):
        assert np.array_equal(ge[k].counts, np.asarray(we[k].counts)), k
    gr, wr = ge["events"].rows, np.asarray(we["events"].rows)
    assert np.array_equal(gr[:, :3], wr[:, :3])     # onset, duration, bin
    assert np.max(np.abs(gr[:, 3] - wr[:, 3])) < DB


def test_compile_caches_differ_only_by_carry_donation(tmp_path):
    """A store-backed tenant and an in-memory tenant with the same
    reductions: the reference compiles two carry updates (it donates
    the carry only when no sink persists it); the port, which has no
    donation, shares one.  Step accounting is the same."""
    def stats(a, serve, m, p, out, extra=lambda j: j):
        svc = serve.SoundscapeService()
        extra(a.job(m, p).features(*FEATS).chunk(4)).submit(svc, name="m")
        extra(a.job(m, p).features(*FEATS).chunk(4)).to(out).submit(
            svc, name="s")
        svc.run(timeout=600)
        return svc.stats()["compile"]

    port = stats(api, tserve, M, P, str(tmp_path / "p"),
                 lambda j: j.device("cpu"))
    ref = stats(japi, jserve, JM, JP, str(tmp_path / "r"))
    assert port["step"] == ref["step"] == {"hits": 1, "misses": 1,
                                           "entries": 1}
    assert ref["reduce"] == {"hits": 0, "misses": 2, "entries": 2}
    assert port["reduce"] == {"hits": 1, "misses": 1, "entries": 1}


@pytest.mark.parametrize("kind", ["rr", "drr"])
def test_schedulers_pick_as_the_reference(kind):
    """Random runnable subsets and charges: both packages' schedulers
    give the same pick sequence for the same weights."""
    weights = {"a": 1.0, "b": 2.0, "c": 0.5, "d": 3.0}
    rng = np.random.default_rng(5)
    make = {"rr": (RoundRobin, jserve.RoundRobin),
            "drr": (DeficitRoundRobin, jserve.DeficitRoundRobin)}[kind]
    port, ref = make[0](), make[1]()
    for t, w in weights.items():
        port.add(t, w)
        ref.add(t, w)
    picks = []
    for turn in range(200):
        run = [t for t in weights if rng.random() < 0.7] or ["a"]
        a, b = port.pick(run), ref.pick(run)
        assert a == b, (turn, run)
        steps = int(rng.integers(0, 3))
        port.charge(a, steps)
        ref.charge(b, steps)
        picks.append(a)
        if turn == 100:
            port.remove("c")
            ref.remove("c")
            del weights["c"]
    assert len(set(picks)) == 4


@pytest.mark.parametrize("fmt", ["store", "zarr"])
def test_serve_cli_verifies_bitwise(fmt, tmp_path, capsys):
    """``python -m repro_torch.launch.serve --device cpu --verify``:
    batch and live tenants drain, every one bitwise equal to its solo
    run (zarr tenants read back from their chunks)."""
    from repro_torch.launch import serve as serve_cli
    args = ["--device", "cpu", "--tenants", "2", "--live", "1",
            "--files", "2", "--records-per-file", "3", "--record-sec",
            "0.05", "--chunk", "2", "--scheduler", "drr", "--weights",
            "1,2", "--verify"]
    if fmt == "zarr":
        args += ["--out-root", str(tmp_path), "--sink-format", "zarr"]
    serve_cli.main(args)
    out = capsys.readouterr().out
    for name in ("batch-0", "batch-1", "live-0"):
        assert f"[serve] verify {name}: bitwise-identical" in out
    # the two synthesized tenants share a step; the live one builds its own
    assert "step 1 hits / 2 misses" in out
    if fmt == "zarr":
        assert out.count("(committed through 2010-06-03T12:00:00") == 3


def test_serve_cli_without_cuda_exits_naming_the_flag(monkeypatch,
                                                      capsys):
    from repro_torch.launch import serve as serve_cli
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--tenants", "1"])
    assert exc.value.code != 0
    assert "--device cuda: no CUDA device" in capsys.readouterr().err


# -- on the card -------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")


def _card_job(root):
    return (api.job(M, P).features("welch", "spl", "tol").chunk(4)
            .source(api.WavSource(root)).async_io().device("cuda"))


@pytest.mark.cuda
def test_background_drain_on_card_is_bitwise(dataset):
    _needs_card()
    want = _card_job(dataset).run()
    svc = SoundscapeService(quantum=1).start()
    try:
        handles = [_card_job(dataset).submit(svc, name=f"t{i}")
                   for i in range(3)]
        got = [h.result(timeout=600) for h in handles]
    finally:
        svc.stop()
    for res in got:
        assert_bitwise(res, want)
    assert svc.stats()["compile"]["step"] == {"hits": 2, "misses": 1,
                                              "entries": 1}


@pytest.mark.cuda
def test_device_memory_back_to_baseline_after_drain(dataset, tmp_path):
    _needs_card()
    _card_job(dataset).run()          # builds the kernels and FFT plans
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    svc = SoundscapeService()
    handles = [_card_job(dataset).to(str(tmp_path / f"s{i}"))
               .submit(svc, name=f"t{i}") for i in range(2)]
    svc.run(timeout=600)
    for h in handles:
        h.result()
    del svc, handles, h
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
