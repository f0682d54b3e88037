"""``LiveSource.fetch_into``: a step's records copied out of the ring as
each lands, outside the ring's lock, into a buffer the caller owns.

On the CPU: the bytes equal ``fetch``'s, earlier records are copied
before the step's last push (``source.copy`` spans with ``early``), a
producer blocked on a full ring does not refill a slot that a fetch is
still reading, an evicted record still raises ``RingOverrun``, and
``end()`` during a fetch zero-fills what never arrives.  On the card
(``cuda`` marker): a live job that fills its pinned staging slot this
way gives the same bits as one fed through a source without
``fetch_into``.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api, trace
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.faults.errors import StreamStall
from repro_torch.serve import LiveSource, RingOverrun

SIZE = 16
DTYPES = {"int16": np.int16, "float32": np.float32}


def _records(n, payload, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3000, 3000, (n, SIZE)).astype(DTYPES[payload])


def _thread(target, *args):
    th = threading.Thread(target=target, args=args, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("payload", ["int16", "float32"])
def test_fetch_into_gives_the_bytes_of_fetch(payload):
    """Two rings fed the same pushes, one read with ``fetch``, the other
    with ``fetch_into`` over a dirty buffer: runs that wrap the ring,
    indices out of order, a step shaped (2, 3) with padding past the
    bound manifest."""
    m = DatasetManifest(n_files=1, records_per_file=10, record_size=SIZE,
                        fs=16)
    recs = _records(10, payload)
    a, b = (LiveSource(SIZE, capacity=6, payload_dtype=payload).bind(m, None)
            for _ in range(2))
    for src in (a, b):
        src.push(recs[:6])
    steps = [np.array([0, 1, 2]), np.array([4, 3]),
             np.array([[5, 6, 7], [8, 9, 10]])]
    for step in steps:
        for src in (a, b):
            src.push(recs[src.pushed:min(10, int(step.max()) + 1)])
        want = a.fetch(step)
        out = np.full(step.shape + (SIZE,), 7, DTYPES[payload])
        got = b.fetch_into(step, out)
        assert got is out and got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert not want[1, 2].any()                       # padding
    assert a._consumed == b._consumed == 10
    with pytest.raises(ValueError, match="C-contiguous"):
        b.fetch_into(np.array([9]), np.zeros((1, SIZE), np.float64))


def test_earlier_records_are_copied_before_the_last_push():
    """The producer pushes three of a step's four records and holds the
    fourth until the fetch has copied those three: each copy of them
    began before the last push, and says so with ``early``."""
    src = LiveSource(SIZE, capacity=8, payload_dtype="int16")
    recs = _records(4, "int16")
    out = np.empty((4, SIZE), np.int16)

    def copied():
        return sum(s.attrs["records"] for s in trace.snapshot().spans
                   if s.name == "source.copy")

    def producer():
        src.push(recs[:3])
        deadline = time.monotonic() + 30
        while copied() < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        src.push(recs[3])

    trace.enable()
    try:
        th = _thread(producer)
        src.fetch_into(np.arange(4), out)
        th.join(timeout=30)
        spans = trace.snapshot().spans
    finally:
        trace.disable()
    assert not th.is_alive()
    assert np.array_equal(out, recs)
    last_push = int(src._stamp[3])
    copies = [s for s in spans if s.name == "source.copy"]
    early = [s for s in copies if s.attrs["early"]]
    assert sum(s.attrs["records"] for s in early) == 3
    assert all(s.start_ns < last_push for s in early)
    late = [s for s in copies if not s.attrs["early"]]
    assert [s.attrs["records"] for s in late] == [1]
    waits = sorted((s for s in spans if s.name == "source.wait"),
                   key=lambda s: s.start_ns)
    assert waits[-1].attrs["ready_ns"] == last_push
    assert all("ready_ns" not in w.attrs for w in waits[:-1])


class _HeldCopy(LiveSource):
    """A ring whose copies out wait for ``release`` once begun."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.begun, self.release = threading.Event(), threading.Event()

    def _copy_out(self, rows, pos, recs):
        self.begun.set()
        assert self.release.wait(timeout=30)
        super()._copy_out(rows, pos, recs)


def test_a_blocked_producer_does_not_refill_a_slot_under_copy():
    """``capacity == chunk``: after a step's fetch the producer may push
    the next record into the slot of the step's first.  While a fetch
    re-reads that step, the push waits until the copy is done."""
    src = _HeldCopy(SIZE, capacity=4, payload_dtype="int16")
    recs = _records(5, "int16")
    src.push(recs[:4])
    src.release.set()
    src.fetch(np.arange(4))             # consumed: 4
    src.begun.clear()
    src.release.clear()
    out = np.empty((4, SIZE), np.int16)
    reader = _thread(src.fetch_into, np.arange(4), out)
    assert src.begun.wait(timeout=30)
    pusher = _thread(src.push, recs[4])
    time.sleep(0.2)
    assert pusher.is_alive() and src.pushed == 4
    src.release.set()
    reader.join(timeout=30)
    pusher.join(timeout=30)
    assert not reader.is_alive() and not pusher.is_alive()
    assert np.array_equal(out, recs[:4])
    assert src.pushed == 5 and src._reading == []


def test_stress_reads_never_see_a_refilled_slot():
    """A producer pushes record ``r`` as rows of value ``r`` with scale
    ``r`` into a ring of two steps, while the consumer fetches each step
    and re-reads the one before it, with the interpreter switching
    threads as often as it can: every read gives its records' own rows
    and scales, or raises ``RingOverrun`` for a record already
    refilled."""
    n, chunk = 2000, 4
    src = LiveSource(SIZE, capacity=2 * chunk, payload_dtype="int16",
                     fetch_timeout=30)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        producer = _thread(src.feed, (np.full(SIZE, r, np.int16)
                                      for r in range(n)), np.arange(n))
        overruns = 0
        out = np.empty((chunk, SIZE), np.int16)
        for k in range(n // chunk):
            steps = [np.arange(k * chunk, (k + 1) * chunk)]
            if k:
                steps.append(steps[0] - chunk)
            for idx in steps:
                try:
                    src.fetch_into(idx, out)
                    scales = src.scales(idx)
                except RingOverrun:
                    overruns += 1
                    continue
                assert np.array_equal(out, np.repeat(idx[:, None], SIZE, 1))
                assert np.array_equal(scales, idx)
        producer.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not producer.is_alive()
    assert src._reading == [] and src._consumed == n
    assert overruns < n // chunk


def test_scales_are_those_of_the_records_fetched():
    """A fetched record's slot may be refilled before the engine reads
    the record's decode scale: the scale is the fetched record's."""
    src = LiveSource(SIZE, capacity=4, payload_dtype="int16")
    recs = _records(5, "int16")
    src.push(recs[:4], [1.0, 2.0, 3.0, 4.0])
    src.fetch(np.arange(4))
    src.push(recs[4], 5.0)              # into record 0's slot
    assert src.scales(np.arange(4)).tolist() == [1.0, 2.0, 3.0, 4.0]
    assert src.scales(np.array([4])).tolist() == [5.0]


def test_an_evicted_record_still_raises_ring_overrun():
    src = LiveSource(SIZE, capacity=4, payload_dtype="int16")
    recs = _records(8, "int16")
    src.push(recs[:4])
    src.fetch(np.arange(4))
    src.push(recs[4:])
    with pytest.raises(RingOverrun, match="already evicted"):
        src.fetch_into(np.arange(4), np.empty((4, SIZE), np.int16))
    assert src._reading == []
    assert np.array_equal(src.fetch(np.arange(4, 8)), recs[4:])


def test_end_during_the_fetch_zero_fills_what_never_arrives():
    src = LiveSource(SIZE, capacity=8, payload_dtype="int16")
    recs = _records(2, "int16")
    out = np.full((4, SIZE), 7, np.int16)
    reader = _thread(src.fetch_into, np.arange(4), out)
    src.push(recs)
    time.sleep(0.05)
    assert reader.is_alive()            # records 2 and 3 still due
    src.end()
    reader.join(timeout=30)
    assert not reader.is_alive()
    assert np.array_equal(out[:2], recs)
    assert not out[2:].any()


def test_a_starved_fetch_raises_and_leaves_no_mark():
    src = LiveSource(SIZE, capacity=8, payload_dtype="int16",
                     fetch_timeout=0.1)
    src.push(_records(1, "int16"))
    with pytest.raises(StreamStall, match="starved"):
        src.fetch_into(np.arange(2), np.empty((2, SIZE), np.int16))
    assert src._reading == [] and src._consumed == 0


# -- on the card -------------------------------------------------------

P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.0625)
M = DatasetManifest(n_files=2, records_per_file=6, record_size=P.record_size,
                    fs=P.fs, seed=3)


def _card_run(payload: str, inflight: int, fill: bool):
    """A live job on the card fed from a producer thread; ``fill=False``
    puts a retrying wrapper, which has no ``fetch_into``, round the
    ring.  Returns the result and the pinned copies a step made."""
    rng = np.random.default_rng(11)
    recs = rng.integers(-3000, 3000, (M.n_records, P.record_size))
    recs = recs.astype(DTYPES[payload])
    if payload == "float32":
        recs *= np.float32(1e-4)
    live = LiveSource(P.record_size, capacity=4, payload_dtype=payload)
    job = (api.job(M, P).features("welch", "spl", "tol").source(live)
           .chunk(4).async_io(depth=0, inflight=inflight).payload(payload)
           .device("cuda"))
    if not fill:
        job = job.retry()
    producer = _thread(live.feed, recs, np.linspace(1e-4, 2e-4, len(recs)))
    trace.enable()
    try:
        res = job.run()
        spans = trace.snapshot().spans
    finally:
        trace.disable()
        producer.join(timeout=60)
    assert not producer.is_alive()
    h2d = [s.id for s in spans if s.name == "job.h2d"]
    stages = sum(s.parent in h2d for s in spans if s.name == "h2d.stage")
    return res, stages / len(h2d)


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["int16", "float32"])
@pytest.mark.parametrize("inflight", [0, 1])
def test_filling_the_pinned_slot_on_the_card_is_bitwise(payload, inflight):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    got, got_stages = _card_run(payload, inflight, fill=True)
    want, want_stages = _card_run(payload, inflight, fill=False)
    assert got_stages == want_stages - 1        # the payload's copy
    assert sorted(got.features) == sorted(want.features)
    for name in got.features:
        assert np.array_equal(got.features[name], want.features[name]), name
    assert sorted(got.epoch) == sorted(want.epoch)
    for name in got.epoch:
        assert np.array_equal(got.epoch[name], want.epoch[name]), name
