"""The window carry: the in-place update against the full-size
update it replaced, bit for bit, and what reaches the host.

  * ``compile_reduce_update`` writes only the rows of the windows a step
    hits, in place: gathered by device-side window ids and scattered
    back, with the bits of a loop over the hit windows' row views
    (aligned and straddling steps, one shard and four, fresh and
    resumed), and of the full-size update it replaced.
    ``full_size_update`` below is that update, kept here as an
    oracle: each step built an identity
    partial of the carry's whole size, merged the shards' partials into
    it, and returned a new carry.  Both run the same random steps (sum,
    ksum with -0.0 and zero partials, min, max; int32 counts) over one
    and four shards, from a fresh carry and from one resumed mid-way,
    and every field comes out with the same bits;
  * a streaming sink that takes window flushes gets, with steps in
    flight, each closed window once, from a copy of the closed rows
    alone, while a resumable ``StoreSink``'s every commit still holds the
    whole carry and the live count as they stood after that commit's
    step;
  * on the card (``-m cuda``), where the next update waits for the
    whole carry's copy, a ``StoreSink``'s commits with steps in flight
    have the bits of the synchronous run's.
"""
import numpy as np
import pytest
import torch

from repro_torch import api, trace
from repro_torch.api import engine
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams

P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.0625)
M = DatasetManifest(n_files=3, records_per_file=7, record_size=P.record_size,
                    fs=P.fs, seed=5)
FEATURES = ("welch", "ltsa", "spd", "minmax")
WINDOW = 3


def _segment_reduce(merge, contribs, runs, rows, n_windows):
    out = torch.full((n_windows,) + tuple(contribs.shape[1:]),
                     {"sum": 0.0, "ksum": 0.0, "min": float("inf"),
                      "max": -float("inf")}[merge],
                     dtype=contribs.dtype, device=contribs.device)
    for w, lo, hi in runs:
        sel = contribs.index_select(0, rows[lo:hi])
        if merge in ("sum", "ksum"):
            red = sel.sum(dim=0, dtype=contribs.dtype)
        elif merge == "min":
            red = sel.amin(dim=0)
        else:
            red = sel.amax(dim=0)
        out[w] = red
    return out


def full_size_update(bindings):
    """The carry update before it worked in place: ``state' = state ⊕
    partial``, the partial as large as the carry."""
    combine = {"sum": torch.add, "ksum": torch.add, "min": torch.minimum,
               "max": torch.maximum}

    def merged(merge, contribs, shard_runs, rows, n_windows):
        n = len(shard_runs)
        c = contribs.reshape((n, -1) + tuple(contribs.shape[1:]))
        part = _segment_reduce(merge, c[0], shard_runs[0], rows, n_windows)
        for s in range(1, n):
            part = combine[merge](part, _segment_reduce(
                merge, c[s], shard_runs[s], rows, n_windows))
        return part

    def update(state, out, mask, segments, rows):
        fmask = mask.reshape(-1)
        new = {}
        for b in bindings:
            val = out[b.feature]
            val = val.reshape((-1,) + tuple(val.shape[2:]))
            contribs = b.red.update(val, fmask)
            for f in b.fields:
                key = engine._sk(b, f.name)
                part = merged(f.merge, contribs[f.name], segments[b.wkey],
                              rows, b.n_windows)
                if f.merge == "ksum":
                    y = part - state[key + ":c"]
                    t = state[key] + y
                    zero = part == 0
                    new[key + ":c"] = torch.where(
                        zero, state[key + ":c"], (t - state[key]) - y)
                    new[key] = torch.where(zero, state[key], t)
                elif f.merge == "sum":
                    new[key] = state[key] + part
                else:
                    new[key] = combine[f.merge](state[key], part)
        return new

    return update


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _random_step(rng, step, n_shards, chunk, wins):
    """A step's outputs, live mask and window rows: Welch-like rows with
    exact zeros and -0.0s (zero partials), dB spectrograms, a mask with
    padding, window ids that straddle windows."""
    lead = (n_shards, chunk)
    welch = rng.gamma(2.0, 1.0, lead + (P.n_bins,)).astype(np.float32)
    welch[rng.random(lead) < 0.3] = 0.0
    welch[rng.random(lead) < 0.3] = -0.0
    db = rng.uniform(-130.0, 70.0, lead + (3, P.n_bins)).astype(np.float32)
    mask = rng.random(lead) < 0.8
    idx = (step * n_shards * chunk + np.arange(n_shards * chunk)
           ).reshape(lead) % M.n_records
    ids = {k: w.ids(idx, M) for k, w in wins.items()}
    segments, rows = engine._window_rows(ids)
    index = engine._carry_index(rows, mask)
    w = torch.from_numpy(welch)
    # the extrema see no -0.0: a tie of 0.0 with -0.0 is settled by
    # where the element sits in the CPU's vector lanes, in the full-size
    # update as well, and no PSD (a sum of squares) reaches -0.0
    out = {"welch": w, "ltsa": w, "minmax": w.abs(),
           "spd": torch.from_numpy(db)}
    return (out, torch.from_numpy(mask), segments, torch.from_numpy(rows),
            torch.from_numpy(index))


@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_in_place_update_has_the_full_size_bits(n_shards, resumed):
    specs = api.resolve_features(list(FEATURES))
    bindings, wins = engine.resolve_bindings(
        specs, M, P, engine.Window("records", records=WINDOW))
    assert {f.merge for b in bindings for f in b.fields} \
        == {"sum", "ksum", "min", "max"}
    rng = np.random.default_rng(n_shards)
    old, new = full_size_update(bindings), \
        engine.compile_reduce_update(bindings)
    want = engine._init_reduce_state(bindings, None, "cpu")
    steps = [_random_step(rng, s, n_shards, 2, wins) for s in range(8)]
    if resumed:
        # a carry committed mid-way, with -0.0 in the Kahan companions
        for out, mask, seg, rows, _ in steps[:3]:
            want = old(want, out, mask, seg, rows)
        for k in want:
            if k.endswith(":c"):
                want[k][::2] = -0.0
        steps = steps[3:]
    got = {k: v.clone() for k, v in want.items()}
    for out, mask, seg, rows, index in steps:
        want = old(want, out, mask, seg, rows)
        same = new(got, out, seg, index)
        assert same is got
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), k


def per_window_update(bindings):
    """The in-place update one window at a time: each hit window's row
    (and Kahan companion) as a view of the carry, merged in place."""
    combine = {"sum": torch.add, "ksum": torch.add, "min": torch.minimum,
               "max": torch.maximum}

    def update(state, out, mask, segments, rows):
        fmask = mask.reshape(-1)
        for b in bindings:
            val = out[b.feature]
            val = val.reshape((-1,) + tuple(val.shape[2:]))
            contribs = b.red.update(val, fmask)
            shard_runs = segments[b.wkey]
            for f in b.fields:
                c = contribs[f.name]
                c = c.reshape((len(shard_runs), -1) + tuple(c.shape[1:]))
                key = engine._sk(b, f.name)
                for w, ranges in engine._window_hits(shard_runs):
                    part = None
                    for s, lo, hi in ranges:
                        sel = c[s].index_select(0, rows[lo:hi])
                        red = sel.sum(dim=0, dtype=c.dtype) \
                            if f.merge in ("sum", "ksum") else \
                            sel.amin(dim=0) if f.merge == "min" else \
                            sel.amax(dim=0)
                        part = red if part is None \
                            else combine[f.merge](part, red)
                    row = state[key][w]
                    if f.merge == "ksum":
                        comp = state[key + ":c"][w]
                        y = part - comp
                        t = row + y
                        zero = part == 0
                        torch.where(zero, comp, (t - row) - y, out=comp)
                        torch.where(zero, row, t, out=row)
                    elif f.merge == "sum":
                        row.add_(part)
                    else:
                        combine[f.merge](row, part, out=row)
        return state

    return update


KAHAN_LTSA = api.FeatureSpec(
    name="kltsa", shape=None, compute=lambda ctx: ctx.welch,
    reductions=(api.mean_reduction("kltsa", lambda m, p: p.n_bins,
                                   kahan=True),))
LONG = DatasetManifest(n_files=4, records_per_file=100,
                       record_size=P.record_size, fs=P.fs, seed=5)


@pytest.mark.parametrize("resumed", [False, True], ids=["fresh", "resumed"])
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("k", [0, 2, 4, 6], ids=lambda k: f"k{k}")
def test_gathered_update_has_the_per_window_loop_bits(k, n_shards,
                                                      resumed):
    """Steps of 8 records a shard over 90-record windows, each shard's
    records straddling a window edge with ``k`` of them before it (k = 0:
    no edge), the windows moving on each step: the update that gathers
    the hit windows' rows by device-side ids and scatters them back
    gives the bits of the per-window loop, for sum, ksum, min, max and
    int32 counts."""
    specs = api.resolve_features(list(FEATURES) + [KAHAN_LTSA])
    bindings, wins = engine.resolve_bindings(
        specs, LONG, P, engine.Window("records", records=90))
    assert {(f.merge, b.n_windows > 1) for b in bindings for f in b.fields} \
        >= {("sum", True), ("ksum", True), ("min", True), ("max", True),
            ("ksum", False)}
    rng = np.random.default_rng(100 * k + n_shards)
    want = engine._init_reduce_state(bindings, None, "cpu")
    if resumed:
        # a carry committed mid-way: rows already summed, -0.0 in the
        # Kahan companions
        for key, v in want.items():
            if v.dtype == torch.int32:
                v.copy_(torch.from_numpy(
                    rng.integers(0, 50, tuple(v.shape), dtype=np.int32)))
            elif key.endswith(":c"):
                v.copy_(torch.from_numpy(rng.normal(
                    0, 1e-7, tuple(v.shape)).astype(np.float32)))
                v[::2] = -0.0
            else:
                v.copy_(torch.from_numpy(rng.gamma(
                    2.0, 10.0, tuple(v.shape)).astype(np.float32)))
    got = {key: v.clone() for key, v in want.items()}
    old, new = per_window_update(bindings), \
        engine.compile_reduce_update(bindings)
    for step in range(3):
        out, mask, _, _, _ = _random_step(rng, 0, n_shards, 8, wins)
        out["kltsa"] = out["welch"]
        # shard s straddles the edge of window 1 + 2s + step
        idx = np.stack([(1 + 2 * s + step) * 90 - k + np.arange(8)
                        for s in range(n_shards)])
        segments, rows = engine._window_rows(
            {key: w.ids(idx, LONG) for key, w in wins.items()})
        index = torch.from_numpy(engine._carry_index(rows, mask.numpy()))
        want = old(want, out, mask, segments, torch.from_numpy(rows))
        assert new(got, out, segments, index) is got
        for key in want:
            assert torch.equal(_bits(got[key]), _bits(want[key])), key


class RecordingStore(api.StoreSink):
    """A resumable store that keeps what each commit received."""

    def __init__(self, path):
        super().__init__(str(path))
        self.commits = []

    def commit(self, plan, step, agg, live):
        self.commits.append((step, {k: np.array(v) for k, v in agg.items()},
                             live))
        super().commit(plan, step, agg, live)


def _job(sink, inflight, device="cpu"):
    job = (api.job(M, P).features(*FEATURES).window(records=WINDOW)
           .chunk(2).to(sink).device(device))
    return job.sync_io() if inflight is None else \
        job.async_io(depth=0, inflight=inflight)


def _carry_after_each_step():
    """The carry and the live count after each step of a run without
    steps in flight."""
    st = _job(None, 0)._stepper()
    st.start()
    states = []
    while st.step_once():
        states.append(({k: v.numpy().copy() for k, v in
                        st._agg_state.items()}, st._live))
    res = st.finish()
    st.close()
    return states, res


def test_closed_rows_stream_and_the_store_commits_the_whole_carry(
        tmp_path):
    states, res = _carry_after_each_step()
    windows = res[2]

    store = RecordingStore(tmp_path / "store")
    _job(store, 2).run()
    assert [s for s, _, _ in store.commits] == list(range(len(states)))
    for step, agg, live in store.commits:
        want, want_live = states[step]
        assert set(agg) == set(want)
        for k in agg:
            assert np.array_equal(agg[k].view(np.uint8),
                                  want[k].view(np.uint8)), (step, k)
        assert live == want_live == min(2 * (step + 1), M.n_records)

    flushed = {}

    def on_windows(name, start, values):
        for w, row in enumerate(values, start):
            flushed.setdefault((name, w), []).append(np.array(row))

    trace.enable()
    try:
        _job(api.CallbackSink(lambda *a: None, on_windows=on_windows),
             2).run()
        spans = trace.snapshot().spans
    finally:
        trace.disable()
    for name, rows in windows.items():
        for w in range(rows.shape[0]):
            assert len(flushed[(name, w)]) == 1, (name, w)
            assert np.array_equal(flushed[(name, w)][0], rows[w])
    # the carry bytes a step sends: the rows of the windows it closes
    row = {b.out_name: sum(
        np.dtype(f.dtype).itemsize * int(np.prod((1,) + f.shape)) *
        (2 if f.merge == "ksum" else 1) for f in b.fields)
        for b in engine.resolve_bindings(
            api.resolve_features(list(FEATURES)), M, P,
            engine.Window("records", records=WINDOW))[0]
        if not b.to_epoch}
    carry = [s for s in spans if s.name == "job.carry"]
    assert len(carry) == len(states)
    closed = [min((s + 1) * 2, M.n_records) // WINDOW
              for s in range(len(states))]
    for s, c in zip(carry, closed):
        k = carry.index(s)
        before = closed[k - 1] if k else 0
        assert s.attrs["d2h_bytes"] == (c - before) * sum(row.values())


@pytest.mark.cuda
@pytest.mark.parametrize("inflight", [1, 2])
def test_store_commits_on_the_card_have_the_synchronous_bits(tmp_path,
                                                            inflight):
    """On the card the next in-place update waits for the whole carry's
    copy: with steps in flight, every commit a ``StoreSink`` receives
    holds the bits the synchronous run commits at that step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the copy streams and the event the "
                    "next update waits on exist only there")
    runs = {}
    for name, depth in (("sync", None), ("async", inflight)):
        store = RecordingStore(tmp_path / name)
        _job(store, depth, "cuda").run()
        runs[name] = store.commits
    want, got = runs["sync"], runs["async"]
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (step, agg, live), (_, ref, ref_live) in zip(got, want):
        assert set(agg) == set(ref) and live == ref_live, step
        for k in agg:
            assert np.array_equal(agg[k].view(np.uint8),
                                  ref[k].view(np.uint8)), (step, k)
