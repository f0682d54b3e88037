"""The port's pipelined executor: sync/async bitwise equivalence (event
logs and windowed outputs included), AsyncSink ordering and crash
semantics, PrefetchSource, and the port's async job against the
reference's — the cases of the reference's ``tests/test_async.py``, on
the CPU device (``.device("cpu")``: the same queue, prefetch and
AsyncSink over plain tensors)."""
import threading
import time

import numpy as np
import pytest

from repro import api as japi
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro_torch import api
from repro_torch.api import engine
from repro_torch.core.manifest import DatasetManifest, plan
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore
from repro_torch.data.wavio import write_dataset

PKW = dict(nfft=256, window_size=256, window_overlap=128,
           record_size_sec=0.25)
MKW = dict(n_files=3, records_per_file=4, seed=11)
P = DepamParams(**PKW)
M = DatasetManifest(record_size=P.record_size, fs=P.fs, **MKW)
ALL = ("welch", "spl", "tol", "percentiles", "ltsa", "spd", "minmax")
THRESHOLD_DB = -12.0       # between the quiet tone and the bursts
TIMEOUT = 10.0


def make_reader(m=M):
    """Deterministic per-record reader (the lineage property), shape-
    agnostic over the index array as PrefetchSource requires: a quiet
    tone plus a loud burst placed by the record index."""
    t = np.arange(m.record_size, dtype=np.float32) / m.fs

    def reader(idx):
        idx = np.asarray(idx)
        flat = idx.reshape(-1, 1)
        f0 = 40.0 + (flat % 13).astype(np.float32) * 7.0
        x = 0.01 * np.sin(2 * np.pi * f0 * t)
        start = (flat % 5) * (m.record_size // 6)
        burst = (t * m.fs >= start) & (t * m.fs < start + 600)
        x = x + burst * np.sin(2 * np.pi * 900.0 * t)
        return x.astype(np.float32).reshape(*idx.shape, m.record_size)

    return reader


def port_job(reader=None, feats=ALL):
    j = (api.job(M, P).features(*feats).window(records=5).chunk(4)
         .device("cpu"))
    return j.source(reader) if reader is not None else j


def all_names(res):
    return list(res.features or ()) + list(res.epoch) + list(res.windows)


def assert_bitwise(a, b):
    assert all_names(a) == all_names(b)
    for k in all_names(a):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                              equal_nan=True), k
    assert sorted(a.events or ()) == sorted(b.events or ())
    for k in a.events or ():
        assert np.array_equal(a.events[k].counts, b.events[k].counts), k
        assert np.array_equal(a.events[k].rows, b.events[k].rows), k


class TestAsyncEquivalence:
    """Async results are BITWISE-identical to sync: pipelining reorders
    waiting, never computation."""

    def test_hostfed_bitwise_identical(self):
        reader = make_reader()
        sync = port_job(reader).events(THRESHOLD_DB, impulsive=True).run()
        asyn = (port_job(reader).events(THRESHOLD_DB, impulsive=True)
                .async_io(depth=2).run())
        assert sync.events["events"].n_events > 0
        assert_bitwise(sync, asyn)
        assert sync.n_records == asyn.n_records == M.n_records

    def test_device_synth_bitwise_identical(self):
        sync = port_job().run()
        asyn = port_job().async_io().run()
        assert_bitwise(sync, asyn)

    @pytest.mark.parametrize("inflight", [0, 1, 3])
    def test_inflight_and_donate_do_not_change_bits(self, inflight):
        reader = make_reader()
        sync = port_job(reader).run()
        for donate in (True, False):
            j = port_job(reader).sync_io()
            j._exec = api.ExecOptions(inflight=inflight, prefetch_depth=1,
                                      donate=donate)
            assert_bitwise(sync, j.run())

    def test_async_resume_mid_job_bitwise(self, tmp_path):
        """Crash after 1 step under the pipelined executor, resume async;
        equals the sync one-shot bitwise, windows and events included."""
        d = str(tmp_path / "s")
        reader = make_reader()
        (port_job(reader).events(THRESHOLD_DB).to(d).limit(1)
         .async_io(depth=2).run())
        cur = FeatureStore(d).load_cursor()
        assert cur is not None and cur["cursor"] == 4
        resumed = (port_job(reader).events(THRESHOLD_DB).to(d)
                   .async_io(depth=2).run())
        oneshot = port_job(reader).events(THRESHOLD_DB).run()
        assert_bitwise(resumed, oneshot)
        assert resumed.n_records == M.n_records

    def test_sync_resume_of_async_run_and_vice_versa(self, tmp_path):
        """Executor modes interoperate through the store: a job stopped
        in one mode resumes in the other with identical results."""
        reader = make_reader()
        oneshot = port_job(reader).events(THRESHOLD_DB).run()
        d1 = str(tmp_path / "a_then_s")
        port_job(reader).events(THRESHOLD_DB).to(d1).limit(1).async_io() \
            .run()
        r1 = port_job(reader).events(THRESHOLD_DB).to(d1).run()
        d2 = str(tmp_path / "s_then_a")
        port_job(reader).events(THRESHOLD_DB).to(d2).limit(2).run()
        r2 = port_job(reader).events(THRESHOLD_DB).to(d2).async_io().run()
        for r in (r1, r2):
            assert_bitwise(r, oneshot)

    def test_callback_sink_keeps_arrays_of_its_own(self):
        """Arrays a streaming sink keeps stay what they were when handed
        over, however many steps the pipeline runs after them."""
        reader = make_reader()
        kept = []
        (port_job(reader, ("welch", "spl"))
         .to(lambda step, idx, vals: kept.append((idx, vals)))
         .async_io(inflight=3).run())
        want = port_job(reader, ("welch", "spl")).run()
        assert len(kept) == plan(M, 1, 4).n_steps
        for idx, vals in kept:
            for k in ("welch", "spl"):
                assert np.array_equal(vals[k], want[k][idx]), k


class RecordingSink(api.Sink):
    """Records the (op, step) sequence the worker applies."""

    wants_commit = True

    def __init__(self):
        self.events = []

    def write(self, step, indices, values):
        self.events.append(("write", step, threading.get_ident()))

    def commit(self, plan, step, agg, live):
        self.events.append(("commit", step, threading.get_ident()))


class TestAsyncSink:
    def test_strict_step_ordering_preserved(self):
        """write(k) before commit(k), steps ascending, all off the
        driver thread."""
        inner = RecordingSink()
        res = port_job(None, ("spl",)).to(inner).async_io().run()
        assert res.n_records == M.n_records
        ops = [(op, step) for op, step, _tid in inner.events]
        n_steps = plan(M, 1, 4).n_steps
        assert ops == [(op, s) for s in range(n_steps)
                       for op in ("write", "commit")]
        driver = threading.get_ident()
        assert all(tid != driver for _, _, tid in inner.events)

    def test_worker_error_propagates_to_driver(self):
        class FailingSink(api.Sink):
            def write(self, step, indices, values):
                raise IOError("disk full")

        with pytest.raises(RuntimeError, match="AsyncSink worker failed"):
            port_job(None, ("spl",)).to(FailingSink()).async_io().run()

    def test_flush_blocks_until_applied(self):
        gate = threading.Event()
        applied = []

        class SlowSink(api.Sink):
            wants_commit = False

            def write(self, step, indices, values):
                gate.wait(timeout=TIMEOUT)
                applied.append(step)

        asink = api.AsyncSink(SlowSink(), queue_size=4)
        asink.open(M, P, {"spl": ()}, plan(M, 1, 4))
        asink.write(0, np.arange(4), {"spl": np.zeros(4, np.float32)})
        assert applied == []          # queued, not yet applied
        gate.set()
        asink.flush()
        assert applied == [0]
        asink.close()

    def test_crash_mid_queue_commit_never_exceeds_durable_writes(
            self, tmp_path):
        """Kill the writer with work still queued: after reopening, the
        committed cursor covers only steps whose writes fully landed,
        and resuming completes the job bitwise-identically."""
        d = str(tmp_path / "s")
        pl_ = plan(M, 1, 4)
        release_step1 = threading.Event()

        class BlockingStoreSink(api.StoreSink):
            def write(self, step, indices, values):
                if step == 1:
                    release_step1.wait(timeout=TIMEOUT)
                super().write(step, indices, values)

        oneshot = port_job(None, ("welch",)).run()
        rows = {s: (pl_.step_indices(s).reshape(-1),
                    oneshot["welch"][pl_.step_indices(s).reshape(-1)])
                for s in range(3)}
        # a commit payload in the engine's own layout (zero state is
        # fine: only the per-record arrays are checked after resume)
        bindings, _ = engine.resolve_bindings(
            api.resolve_features(["welch"]), M, P, None)
        agg = {k: v.numpy().astype(np.float64) for k, v in
               engine._init_reduce_state(bindings, None, "cpu").items()
               if k != "__live__"}

        asink = api.AsyncSink(BlockingStoreSink(d), queue_size=8)
        asink.open(M, P, {"welch": (P.n_bins,)}, pl_)
        for s in range(3):
            idx, vals = rows[s]
            asink.write(s, idx, {"welch": vals})
            asink.commit(pl_, s, agg, float(4 * (s + 1)))
        # worker: write0, commit0 applied; blocked inside write1;
        # commit1..commit2 still queued -> the "crash" discards them
        deadline = time.monotonic() + TIMEOUT
        while not FeatureStore(d).load_cursor() \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        # _abort sets the kill flag first, then joins; release the gate
        # moments later so the in-flight write1 can finish dying
        timer = threading.Timer(0.05, release_step1.set)
        timer.start()
        asink._abort()
        timer.join(timeout=TIMEOUT)
        assert not timer.is_alive()

        st = FeatureStore(d)
        assert st.committed_steps(pl_) == 1    # never ahead of the data
        on_disk = st.open_arrays({"welch": (M.n_records, P.n_bins)})
        assert np.array_equal(on_disk["welch"][rows[0][0]], rows[0][1])

        resumed = port_job(None, ("welch",)).to(d).run()
        assert np.array_equal(np.asarray(resumed["welch"]),
                              oneshot["welch"])

    def test_queued_commit_behind_failed_write_never_lands(self, tmp_path):
        """The worker error is sticky: once write(k) fails, the commit(k)
        already in the queue is discarded — a cursor never covers data
        that is not on disk."""
        d = str(tmp_path / "s")
        pl_ = plan(M, 1, 4)
        gate = threading.Event()

        class FailingWriteStoreSink(api.StoreSink):
            def write(self, step, indices, values):
                gate.wait(timeout=TIMEOUT)
                raise IOError("disk full")

        asink = api.AsyncSink(FailingWriteStoreSink(d), queue_size=8)
        asink.open(M, P, {"spl": ()}, pl_)
        asink.write(0, pl_.step_indices(0).reshape(-1),
                    {"spl": np.zeros(4, np.float32)})
        asink.commit(pl_, 0, {}, 4.0)     # queued behind the doomed write
        gate.set()
        with pytest.raises(RuntimeError, match="AsyncSink worker failed"):
            asink.flush()
        with pytest.raises(RuntimeError):  # sticky through close, too
            asink.close()
        assert FeatureStore(d).committed_steps(pl_) == 0

    def test_committed_steps_flushes_pending(self, tmp_path):
        d = str(tmp_path / "s")
        pl_ = plan(M, 1, 4)
        asink = api.AsyncSink(api.StoreSink(d))
        asink.open(M, P, {"spl": ()}, pl_)
        asink.write(0, pl_.step_indices(0).reshape(-1),
                    {"spl": np.ones(4, np.float32)})
        asink.commit(pl_, 0, {}, 4.0)
        assert asink.committed_steps(pl_) == 1
        asink.close()


class TestPrefetchSource:
    def test_rejects_device_synth(self):
        with pytest.raises(ValueError, match="host-fed"):
            api.PrefetchSource(api.SynthSource())

    def test_normalizes_inner_like_as_source(self):
        src = api.PrefetchSource(make_reader(), depth=3)
        assert isinstance(src.inner, api.ReaderSource)
        assert not src.device_synth
        assert src.with_payload("float32") is src

    def test_stream_matches_inline_fetch(self):
        reader = make_reader()
        pl_ = plan(M, 2, 3)
        inline = api.ReaderSource(reader)
        pre = api.PrefetchSource(reader, depth=2, overdecompose=3)
        got = list(pre.stream(pl_, 1, pl_.n_steps))
        want = list(inline.stream(pl_, 1, pl_.n_steps))
        assert len(got) == len(want) == pl_.n_steps - 1
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        assert pre.last_stats is not None and pre.last_stats["tasks"] > 0

    def test_double_wrap_is_not_applied_by_builder(self):
        """async_io() must not re-wrap an explicit PrefetchSource."""
        pre = api.PrefetchSource(make_reader(), depth=4, workers=2)
        j = port_job(pre, ("spl",)).async_io()
        stepper = j._stepper()
        assert stepper.source is pre
        assert isinstance(stepper.sink, api.AsyncSink)
        stepper.close()
        res = j.run()
        assert res.n_records == M.n_records
        sync = port_job(make_reader(), ("spl",)).run()
        assert np.array_equal(res["spl"], sync["spl"])

    @pytest.mark.parametrize("payload", ["float32", "int16"])
    def test_wav_source_options_and_prefetch(self, tmp_path, payload):
        """WavSource's reference signature: the per-record reader
        (coalesced=False) and a one-handle cache under four prefetch
        threads give the same bytes as the default reader."""
        root = str(tmp_path / "wavs")
        write_dataset(root, M)
        want = (port_job(api.WavSource(root), ("welch", "spl"))
                .payload(payload).run())
        for src in (api.WavSource(root, False),
                    api.WavSource(root, max_open_files=1)):
            got = (port_job(api.PrefetchSource(src, workers=4),
                            ("welch", "spl")).payload(payload)
                   .async_io().run())
            assert_bitwise(got, want)


def test_exec_options_validation():
    assert api.ExecOptions() == api.ExecOptions(0, 0, 8, True)
    for bad in (dict(inflight=-1), dict(prefetch_depth=-1),
                dict(queue_size=0)):
        with pytest.raises(ValueError, match="invalid ExecOptions"):
            api.ExecOptions(**bad)


def test_async_job_matches_reference_async_job():
    """The port's pipelined job against the reference's on the same
    numpy reader, within tests/test_torch_job.py's set-1 tolerances."""
    reader = make_reader()
    feats = ("welch", "spl", "tol", "ltsa", "minmax")
    got = port_job(reader, feats).async_io().run()
    jm = JManifest(record_size=P.record_size, fs=P.fs, **MKW)
    want = (japi.job(jm, JParams(**PKW)).features(*feats).window(records=5)
            .chunk(4).source(reader).async_io().run())
    assert all_names(got) == all_names(want)
    for k in all_names(want):
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        if k in ("spl", "tol"):
            assert np.max(np.abs(g - w)) < 1e-3, k
        else:
            assert np.max(np.abs(g - w) / np.abs(w)) < 1e-4, k
