"""The port's fault layer: the bitwise-or-loud chaos property.

The cases of the reference's ``tests/test_faults.py`` that need neither
a serving layer nor a live source, on the CPU device: under any
injected fault schedule, a run either completes bitwise equal to the
fault-free run, or fails loudly with an error naming the fault.  Beside
them: ``FaultPlan`` schedules and ``Quarantine`` reports equal to the
reference's for the same inputs, a store the reference committed with a
quarantined record resumes in the port, the chaos script at its small
size, and (on the card) one healed faulted job.
"""
import os
import subprocess
import sys
import threading
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as japi
from repro import faults as jfaults
from repro.core.manifest import DatasetManifest as JManifest
from repro.core.params import DepamParams as JParams
from repro_torch import api
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.core.store import FeatureStore
from repro_torch.data.wavio import write_dataset
from repro_torch.faults import (FaultPlan, FaultSpec, Quarantine, Retrier,
                                RetryPolicy)
from repro_torch.faults import errors as port_errors
from repro_torch.faults.errors import (CorruptRecordError, InjectedCrash,
                                       QuarantineExceeded, RetryExhausted,
                                       SinkWriteError, StoreIntegrityError,
                                       StreamStall, TransientReadError,
                                       TruncatedRecordError, is_bad_record,
                                       is_retryable)

ROOT = Path(__file__).resolve().parents[1]
PKW = dict(nfft=256, window_size=256, window_overlap=128,
           record_size_sec=0.25)
MKW = dict(n_files=3, records_per_file=4, seed=11)
P = DepamParams(**PKW)
M = DatasetManifest(record_size=P.record_size, fs=P.fs, **MKW)
JP = JParams(**PKW)
JM = JManifest(record_size=JP.record_size, fs=JP.fs, **MKW)

FAST = dict(base_delay=0.0, max_delay=0.0, jitter=0.0)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wavs"))
    write_dataset(root, M)
    return root


def base_job(wavs, *, payload="float32", sync=True, shards=1):
    j = (api.job(M, P).features("welch", "spl").chunk(4)
         .source(api.WavSource(wavs)).payload(payload).device("cpu"))
    if shards > 1:
        j = j.shards(shards)
    if not sync:
        j = j.async_io(depth=2)
    return j


_BASELINES: dict = {}


def baseline(wavs, **cfg):
    key = tuple(sorted(cfg.items()))
    if key not in _BASELINES:
        _BASELINES[key] = base_job(wavs, **cfg).run()
    return _BASELINES[key]


def assert_bitwise(got, want):
    for name in ("welch", "spl", "mean_welch"):
        assert np.array_equal(np.asarray(got[name]),
                              np.asarray(want[name])), name
    assert got.n_records == want.n_records


# -- taxonomy and plan determinism --------------------------------------

class TestTaxonomy:
    def test_predicates_dispatch_on_class_not_message(self):
        assert is_retryable(TransientReadError("x", record=1))
        assert is_retryable(SinkWriteError("x"))
        assert not is_retryable(CorruptRecordError("x", record=1))
        assert not is_retryable(RetryExhausted("x"))
        assert is_bad_record(CorruptRecordError("x", record=1))
        assert is_bad_record(TruncatedRecordError("x", record=1))
        assert not is_bad_record(TransientReadError("x", record=1))

    def test_stream_stall_is_a_retryable_timeout(self):
        e = StreamStall("starved")
        assert isinstance(e, TimeoutError)
        assert is_retryable(e)

    def test_truncated_record_is_still_a_value_error(self):
        assert isinstance(TruncatedRecordError("x", record=0), ValueError)

    def test_errors_name_their_fault(self):
        assert TransientReadError("x", record=3).fault == "read_transient"
        assert CorruptRecordError("x", record=3).record == 3
        assert InjectedCrash("store.commit").site == "store.commit"

    def test_unknown_fault_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultSpec("explode")


class TestFaultPlan:
    def test_scheduled_is_a_pure_function_of_the_seed(self):
        mk = lambda s: FaultPlan.scheduled(  # noqa: E731
            s, n_records=64, n_steps=16, transient_reads=3,
            corrupt_records=2, sink_writes=2, crashes=2, slow_reads=1)
        assert mk(7).specs == mk(7).specs
        assert mk(7).specs != mk(8).specs

    @pytest.mark.parametrize("seed", [0, 7, 11, 2024])
    def test_scheduled_equals_the_reference_schedule(self, seed):
        kw = dict(n_records=48, n_steps=12, transient_reads=3,
                  corrupt_records=2, truncated_records=1, sink_writes=2,
                  crashes=3, stalls=1, slow_reads=2, slow_s=0.01,
                  transient_times=2)
        got = FaultPlan.scheduled(seed, **kw).specs
        want = jfaults.FaultPlan.scheduled(seed, **kw).specs
        assert [tuple(vars(s).values()) for s in got] == \
            [tuple(vars(s).values()) for s in want]
        assert [s.site for s in got] == [s.site for s in want]

    def test_read_faults_match_by_record_not_invocation(self):
        plan = FaultPlan([FaultSpec("read_transient", record=5, times=1)])
        plan.check_read(np.array([0, 1, 2]))       # no match, no firing
        with pytest.raises(TransientReadError, match="record 5"):
            plan.check_read(np.array([4, 5, 6]))
        plan.check_read(np.array([4, 5, 6]))       # budget consumed
        assert plan.stats()["firings"] == 1

    def test_fire_budget_is_exact_under_races(self):
        plan = FaultPlan([FaultSpec("read_transient", record=0, times=8)])
        hits = []

        def worker():
            for _ in range(8):
                try:
                    plan.check_read(np.array([0]))
                except TransientReadError:
                    hits.append(1)
        ts = [threading.Thread(target=worker) for _ in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert len(hits) == 8

    def test_retry_delay_deterministic_and_capped(self):
        pol = RetryPolicy(attempts=5, base_delay=0.01, max_delay=0.04,
                          jitter=0.5, seed=3)
        delays = [pol.delay(i) for i in range(5)]
        assert delays == [pol.delay(i) for i in range(5)]
        assert max(delays) <= 0.04 * 1.5
        ref = jfaults.RetryPolicy(attempts=5, base_delay=0.01,
                                  max_delay=0.04, jitter=0.5, seed=3)
        assert delays == [ref.delay(i) for i in range(5)]

    def test_retrier_exhausts_loudly_naming_the_fault(self):
        r = Retrier(RetryPolicy(attempts=2, **FAST))

        def always():
            raise TransientReadError("flaky nfs", record=7)
        with pytest.raises(RetryExhausted,
                           match="read_transient") as ei:
            r.call(always)
        assert isinstance(ei.value.__cause__, TransientReadError)
        assert r.stats()["exhausted"] == 1

    def test_retrier_never_retries_bad_records(self):
        r = Retrier(RetryPolicy(attempts=5, **FAST))
        calls = []

        def bad():
            calls.append(1)
            raise CorruptRecordError("garbage", record=2)
        with pytest.raises(CorruptRecordError):
            r.call(bad)
        assert len(calls) == 1


# -- retry: transient faults heal bitwise -------------------------------

class TestRetryBitwise:
    def test_transient_reads_heal_bitwise(self, wavs):
        plan = FaultPlan([FaultSpec("read_transient", record=2, times=2),
                          FaultSpec("read_transient", record=9, times=1)])
        got = (base_job(wavs).inject(plan)
               .retry(attempts=3, **FAST).run())
        assert plan.stats()["firings"] == 3
        assert_bitwise(got, baseline(wavs))

    def test_transient_sink_writes_heal_bitwise(self, wavs, tmp_path):
        plan = FaultPlan([FaultSpec("sink_write", step=1, times=1),
                          FaultSpec("sink_commit", step=0, times=1)])
        got = (base_job(wavs).to(str(tmp_path / "s")).inject(plan)
               .retry(attempts=3, **FAST).run())
        assert plan.stats()["firings"] == 2
        assert_bitwise(got, baseline(wavs))

    def test_exhausted_budget_fails_loudly(self, wavs):
        plan = FaultPlan([FaultSpec("read_transient", record=2,
                                    times=None)])
        with pytest.raises(RetryExhausted, match="read_transient"):
            base_job(wavs).inject(plan).retry(attempts=2, **FAST).run()

    def test_async_sink_goes_sticky_only_after_budget(self, wavs,
                                                      tmp_path):
        plan = FaultPlan([FaultSpec("sink_write", step=1, times=1)])
        got = (base_job(wavs, sync=False).to(str(tmp_path / "a"))
               .inject(plan).retry(attempts=2, **FAST).run())
        assert plan.stats()["firings"] == 1
        assert_bitwise(got, baseline(wavs, sync=False))
        plan2 = FaultPlan([FaultSpec("sink_write", step=1, times=None)])
        with pytest.raises(RuntimeError,
                           match="AsyncSink worker failed") as ei:
            (base_job(wavs, sync=False).to(str(tmp_path / "b"))
             .inject(plan2).retry(attempts=2, **FAST).run())
        assert isinstance(ei.value.__cause__, RetryExhausted)
        assert isinstance(ei.value.__cause__.__cause__, SinkWriteError)

    def test_no_fault_option_composes_no_layer(self, wavs):
        st = base_job(wavs)._stepper()
        assert type(st.source) is api.WavSource
        assert type(st.sink) is api.MemorySink
        assert st.quarantine is None
        st.close()


# -- quarantine: opt-in bad-record tolerance ----------------------------

class TestQuarantine:
    def test_strict_mode_fails_loudly_naming_fault_and_record(self, wavs):
        plan = FaultPlan([FaultSpec("record_corrupt", record=6,
                                    times=None)])
        with pytest.raises(CorruptRecordError,
                           match="record_corrupt.*record 6"):
            base_job(wavs).inject(plan).run()

    def test_tolerate_masks_and_reports(self, wavs):
        plan = FaultPlan([FaultSpec("record_corrupt", record=6,
                                    times=None),
                          FaultSpec("record_truncated", record=1,
                                    times=None)])
        with pytest.warns(RuntimeWarning, match="quarantine"):
            got = (base_job(wavs).inject(plan)
                   .tolerate(bad_records=2).run())
        assert sorted(got.quarantine["records"]) == [1, 6]
        reasons = got.quarantine["reasons"]
        assert "record_corrupt" in reasons[6]
        assert "record_truncated" in reasons[1]
        want = baseline(wavs)
        ok = [i for i in range(M.n_records) if i not in (1, 6)]
        assert np.array_equal(np.asarray(got["welch"])[ok],
                              np.asarray(want["welch"])[ok])
        assert not np.array_equal(np.asarray(got["mean_welch"]),
                                  np.asarray(want["mean_welch"]))
        assert got.n_records == M.n_records - 2

    def test_budget_exceeded_fails_loudly(self, wavs):
        plan = FaultPlan([FaultSpec("record_corrupt", record=r,
                                    times=None) for r in (1, 5, 9)])
        with pytest.raises(QuarantineExceeded):
            base_job(wavs).inject(plan).tolerate(bad_records=2).run()

    def test_quarantine_rides_commits_and_resumes_bitwise(self, wavs,
                                                          tmp_path):
        d = str(tmp_path / "s")
        plan = FaultPlan([FaultSpec("record_corrupt", record=2,
                                    times=None)])
        with pytest.warns(RuntimeWarning, match="quarantine"):
            (base_job(wavs).to(d).limit(1).inject(plan)
             .tolerate(bad_records=1).run())
        assert FeatureStore(d).load_cursor()["cursor"] == 4
        # without .tolerate() the committed set would be dropped: refuse
        with pytest.raises(ValueError, match="cannot resume"):
            base_job(wavs).to(d).run()
        plan2 = FaultPlan([FaultSpec("record_corrupt", record=2,
                                     times=None)])
        with pytest.warns(RuntimeWarning, match="quarantine"):
            resumed = (base_job(wavs).to(d).inject(plan2)
                       .tolerate(bad_records=1).run())
        plan3 = FaultPlan([FaultSpec("record_corrupt", record=2,
                                     times=None)])
        with pytest.warns(RuntimeWarning, match="quarantine"):
            oneshot = (base_job(wavs).inject(plan3)
                       .tolerate(bad_records=1).run())
        ok = [i for i in range(M.n_records) if i != 2]
        for name in ("welch", "spl"):
            assert np.array_equal(np.asarray(resumed[name])[ok],
                                  np.asarray(oneshot[name])[ok]), name
        assert np.array_equal(np.asarray(resumed["mean_welch"]),
                              np.asarray(oneshot["mean_welch"]))
        assert resumed.quarantine["records"] == [2]

    def test_quarantine_unit_thread_safety_and_budget(self):
        q = Quarantine(3)
        q.add(5, CorruptRecordError("x", record=5))
        q.add(5, CorruptRecordError("x", record=5))   # idempotent
        assert len(q) == 1
        assert q.mask_for(np.array([4, 5, 6])).tolist() \
            == [False, True, False]
        q.seed([7, 9])
        assert sorted(q.as_array().tolist()) == [5, 7, 9]
        with pytest.raises(QuarantineExceeded):
            q.add(11, CorruptRecordError("x", record=11))

    def test_quarantine_report_equals_the_reference(self):
        got, want = Quarantine(4), jfaults.Quarantine(4)
        for q, errs in ((got, port_errors), (want, jfaults.errors)):
            q.add(3, errs.CorruptRecordError("bytes fail decode",
                                             record=3))
            q.add(8, errs.TruncatedRecordError("short file", record=8))
            q.seed(np.array([1]))
        assert got.report() == want.report()
        assert np.array_equal(got.as_array(), want.as_array())

    def test_tolerant_run_reports_as_the_reference(self, wavs):
        """The same corrupt record through both packages' tolerant jobs:
        the same quarantined id and report, the surviving records within
        the reference's tolerance."""
        mk = lambda pkg: pkg.FaultPlan(  # noqa: E731
            [pkg.FaultSpec("record_corrupt", record=6, times=None)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = base_job(wavs).inject(mk(api)).tolerate(
                bad_records=1).run()
            want = (japi.job(JM, JP).features("welch", "spl").chunk(4)
                    .source(japi.WavSource(wavs)).inject(mk(japi))
                    .tolerate(bad_records=1).run())
        assert got.quarantine == want.quarantine
        ok = [i for i in range(M.n_records) if i != 6]
        w = np.asarray(want["welch"])[ok]
        assert np.max(np.abs(got["welch"][ok] - w) / np.abs(w)) < 1e-4
        assert got.n_records == want.n_records

    def test_reference_quarantined_store_resumes_in_port(self, wavs,
                                                         tmp_path):
        """A store the reference committed under ``.tolerate`` with one
        quarantined record resumes in the port under ``.tolerate``: the
        same record id and report as the reference's own resume."""
        jplan = lambda: jfaults.FaultPlan(  # noqa: E731
            [jfaults.FaultSpec("record_corrupt", record=2, times=None)])

        def jjob(d):
            return (japi.job(JM, JP).features("welch", "spl").chunk(4)
                    .source(japi.WavSource(wavs)).to(d).inject(jplan())
                    .tolerate(bad_records=1))

        dirs = [str(tmp_path / n) for n in ("port", "ref")]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for d in dirs:
                jjob(d).limit(1).run()
            want = jjob(dirs[1]).run()
            with pytest.raises(ValueError, match="cannot resume"):
                base_job(wavs).to(dirs[0]).run()
            plan = FaultPlan([FaultSpec("record_corrupt", record=2,
                                        times=None)])
            got = (base_job(wavs).to(dirs[0]).inject(plan)
                   .tolerate(bad_records=1).run())
        assert got.quarantine["records"] == [2]
        assert got.quarantine == want.quarantine
        ok = [i for i in range(M.n_records) if i != 2]
        w = np.asarray(want["welch"])[ok]
        assert np.max(np.abs(got["welch"][ok] - w) / np.abs(w)) < 1e-4
        assert np.max(np.abs(got["mean_welch"] - want["mean_welch"])
                      / np.abs(want["mean_welch"])) < 1e-4


# -- store integrity: crash matrix under a sharded plan -----------------

class TestStoreCrashMatrix:
    @pytest.mark.parametrize("crash_kind", ["crash_after_sidecar",
                                            "crash_before_commit"])
    def test_crash_points_resume_bitwise(self, wavs, tmp_path,
                                         crash_kind):
        d = str(tmp_path / "s")
        plan = FaultPlan([FaultSpec(crash_kind, times=1, after_visits=1)])
        with pytest.raises(InjectedCrash, match=crash_kind):
            base_job(wavs, shards=2).to(d).inject(plan).run()
        cur = FeatureStore(d).load_cursor()
        assert cur is not None and cur["step"] == 0   # first commit only
        resumed = base_job(wavs, shards=2).to(d).run()
        assert_bitwise(resumed, baseline(wavs, shards=2))

    def test_torn_agg_sidecar_fails_loudly_by_name(self, wavs, tmp_path):
        d = str(tmp_path / "s")
        base_job(wavs, shards=2).to(d).limit(1).run()
        st = FeatureStore(d).load_cursor()
        path = os.path.join(d, st["agg_file"])
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        with pytest.raises(StoreIntegrityError, match="agg-") as ei:
            base_job(wavs, shards=2).to(d).run()
        assert ei.value.path == path

    def test_garbage_agg_sidecar_fails_loudly(self, wavs, tmp_path):
        d = str(tmp_path / "s")
        base_job(wavs, shards=2).to(d).limit(1).run()
        st = FeatureStore(d).load_cursor()
        open(os.path.join(d, st["agg_file"]), "wb").write(b"not an npz")
        with pytest.raises(StoreIntegrityError, match="CRC32"):
            base_job(wavs, shards=2).to(d).run()

    def _ev_job(self, wavs, d=None, shards=2):
        j = (api.job(M, P).features("spl").chunk(4).shards(shards)
             .source(api.WavSource(wavs)).device("cpu")
             .events(-25.5, hysteresis_db=0.5, capacity=4))
        return j if d is None else j.to(d)

    def test_torn_event_tail_is_repaired(self, wavs, tmp_path):
        d = str(tmp_path / "s")
        self._ev_job(wavs, d).limit(1).run()
        rpath = os.path.join(d, "events.events.bin")
        with open(rpath, "ab") as f:                # torn half-append
            f.write(b"\x7f" * 10)
        resumed = self._ev_job(wavs, d).run()
        oneshot = self._ev_job(wavs).run()
        ra, oa = resumed.events["events"], oneshot.events["events"]
        assert np.array_equal(ra.counts, oa.counts)
        assert np.array_equal(ra.rows, oa.rows)

    def test_torn_committed_event_prefix_fails_loudly(self, wavs,
                                                      tmp_path):
        d = str(tmp_path / "s")
        self._ev_job(wavs, d).limit(1).run()
        st = FeatureStore(d).load_cursor()
        assert st["events"]["events"] > 0, "need committed rows to tear"
        rpath = os.path.join(d, "events.events.bin")
        blob = bytearray(open(rpath, "rb").read())
        blob[2] ^= 0xFF
        open(rpath, "wb").write(bytes(blob))
        with pytest.raises(StoreIntegrityError,
                           match="events.events.bin"):
            self._ev_job(wavs, d).run()

    def test_crc_actually_covers_the_committed_bytes(self, wavs,
                                                     tmp_path):
        d = str(tmp_path / "s")
        self._ev_job(wavs, d).limit(1).run()
        st = FeatureStore(d).load_cursor()
        n = st["events"]["events"] * len(api.EVENT_COLUMNS) * 4
        with open(os.path.join(d, "events.events.bin"), "rb") as f:
            prefix = f.read(n)
        assert zlib.crc32(prefix) == st["events_crc"]["events"]


# -- the chaos sweep: acceptance anchor ---------------------------------

SWEEP = [dict(payload=pl, sync=sync, shards=sh)
         for sh in (1, 2) for pl in ("float32", "int16")
         for sync in (True, False)]


class TestChaosSweep:
    @pytest.mark.parametrize(
        "cfg", SWEEP,
        ids=["-".join(f"{k}={v}" for k, v in c.items()) for c in SWEEP])
    def test_injected_schedule_is_bitwise_or_loud(self, wavs, tmp_path,
                                                  cfg):
        plan = FaultPlan.scheduled(
            seed=7, n_records=M.n_records, n_steps=3,
            transient_reads=2, sink_writes=1, slow_reads=1,
            slow_s=0.005, transient_times=2)
        got = (base_job(wavs, **cfg).to(str(tmp_path / "s"))
               .inject(plan).retry(attempts=3, **FAST).run())
        assert plan.stats()["firings"] > 0, "schedule never exercised"
        assert_bitwise(got, baseline(wavs, **cfg))

    @pytest.mark.parametrize("cfg", [SWEEP[0], SWEEP[3]],
                             ids=["sync-f32", "async-i16"])
    def test_unhandled_fault_is_loud_never_silent(self, wavs, cfg):
        plan = FaultPlan([FaultSpec("record_corrupt", record=3,
                                    times=None)])
        with pytest.raises(CorruptRecordError, match="record_corrupt"):
            base_job(wavs, **cfg).inject(plan).run()

    def test_sharded_over_executors_heals_bitwise(self, wavs, tmp_path):
        from repro_torch.launch.mesh import device_mesh
        plan = FaultPlan.scheduled(
            seed=3, n_records=M.n_records, n_steps=3,
            transient_reads=2, sink_writes=1, transient_times=2)
        got = (base_job(wavs, shards=2).on(device_mesh(["cpu"] * 2))
               .to(str(tmp_path / "s")).inject(plan)
               .retry(attempts=3, **FAST).run())
        assert plan.stats()["firings"] > 0
        assert_bitwise(got, baseline(wavs, shards=2))


def test_chaos_script_at_small_size():
    """``scripts/torch_chaos_smoke.py --device cpu`` runs its whole
    fixed-seed matrix and passes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_chaos_smoke.py"),
         "--device", "cpu", "--seed", "7"],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "chaos-smoke PASSED" in proc.stdout


# -- on the card ---------------------------------------------------------

@pytest.mark.cuda
def test_healed_faulted_job_on_card(wavs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")

    def job():
        return (api.job(M, P).features("welch", "spl", "tol").chunk(4)
                .shards(2).source(api.WavSource(wavs)).device("cuda"))

    want = job().run()
    plan = FaultPlan.scheduled(seed=7, n_records=M.n_records, n_steps=3,
                               transient_reads=2, sink_writes=1,
                               transient_times=2)
    got = (job().async_io().to(str(tmp_path / "s")).inject(plan)
           .retry(attempts=3, **FAST).run())
    assert plan.stats()["firings"] > 0
    for k in ("welch", "spl", "tol", "mean_welch"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
