"""Readings of a cell that spans several cards: each card's busy time
and the result line's device block on hand-built traces, and a whole
run through the runner's branch for such a cell with stand-ins for the
CUDA calls.  A cell of one card keeps the device block it always had:
the same keys, ``count`` 1, the union busy time."""
import pytest

import bench_tiny
from harness import discover, runner, trace

ONE_CARD_KEYS = ["platform", "kind", "count", "memory_peak_bytes"]


def _two_card_summary() -> trace.Summary:
    """A 100-ns window; card 0 busy 10-30 and 20-40 ns, card 1 35-45."""
    ev = [trace.Event(trace.WINDOW_SPAN, "user_annotation", 0, 100, 1, 0, 7),
          trace.Event("k0", "kernel", 10, 30, 2, 0, 99, 0),
          trace.Event("k0", "kernel", 20, 40, 3, 0, 99, 0),
          trace.Event("k1", "kernel", 35, 45, 4, 0, 98, 1)]
    return trace.summarize(ev, set())


def test_summary_keeps_each_cards_busy_time():
    s = _two_card_summary()
    assert s.busy_ns == [[10, 45]] and s.busy_s == pytest.approx(35e-9)
    assert s.card_busy_s == {0: pytest.approx(30e-9),
                             1: pytest.approx(10e-9)}
    assert s.device_ops == 3


def test_one_card_device_block_keeps_its_keys_and_count():
    untraced = runner.device_block("H100", {None: 123}, None, ())
    assert list(untraced) == ONE_CARD_KEYS
    assert untraced["count"] == 1 and untraced["memory_peak_bytes"] == 123
    s = _two_card_summary()
    traced = runner.device_block("H100", {None: 123}, s, ())
    assert list(traced) == ONE_CARD_KEYS + ["busy_s", "window_s"]
    assert traced["busy_s"] == s.busy_s and traced["window_s"] == s.window_s


def test_several_cards_give_the_fullest_peak_and_each_card():
    peaks = {0: 500, 1: 700, 2: 600, 3: 100}
    block = runner.device_block("H100", peaks, None, (0, 1, 2, 3))
    assert block["count"] == 4 and block["memory_peak_bytes"] == 700
    assert [c["memory_peak_bytes"] for c in block["cards"]] \
        == [500, 700, 600, 100]
    s = _two_card_summary()
    traced = runner.device_block("H100", {0: 5, 1: 7}, s, (0, 1))
    assert traced["busy_s"] == pytest.approx(20e-9)
    assert [c["idle_pct"] for c in traced["cards"]] \
        == [pytest.approx(70.0), pytest.approx(90.0)]


def test_a_run_of_several_cards_reads_every_card(monkeypatch):
    """``runner.run`` through the branch of a cell whose ``chips`` is
    over 1: ``set1.live`` at its tiny size on the CPU, its ``chips`` read
    as 4, the job's cards given as 0 to 3, and the CUDA calls stand-ins
    that log what they are asked.  Every card is synchronised and its
    peak reset after the warm-up and before the window; the result's
    peak is the fullest card's, ``count`` 4, and ``cards`` each card's
    peak.  (The traced busy time by card needs a device trace; the
    hand-built ones above read it.)"""
    import torch
    calls = []
    peaks = {0: 300, 1: 900, 2: 500, 3: 700}
    cell = discover.cell

    def four_chips(spec, workload):
        return dict(cell(spec, workload), chips=4)
    monkeypatch.setattr(discover, "cell", four_chips)
    monkeypatch.setattr(runner, "job_cards", lambda job: (0, 1, 2, 3))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda c: calls.append(("sync", c)))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda c: calls.append(("reset", c)))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda c: calls.append(("peak", c)) or peaks[c])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda c: "stand-in")

    def window_marker(job):
        orig = job.window

        def window(t0, seconds):
            calls.append(("window", None))
            return orig(t0, seconds)
        job.window = window
    out = bench_tiny.run("set1.live", fault=window_marker)
    assert out["correct"], out["checks"]
    assert calls[:9] == [c for k in range(4)
                         for c in (("sync", k), ("reset", k))] \
        + [("window", None)]
    assert calls[9:] == [("peak", k) for k in range(4)]
    dev = out["device"]
    assert dev["count"] == 4 and dev["memory_peak_bytes"] == 900
    assert [(c["index"], c["memory_peak_bytes"]) for c in dev["cards"]] \
        == sorted(peaks.items())
    assert out["metrics"]["peak_device_gib"]["value"] == 900 / 2 ** 30
