"""The readers of the program's chain-run counts (``replays``,
``captures`` and ``eager`` on its ``job.dispatch`` spans): exact shares on
a hand-built window, nothing where the spans carry no count (a program
without step graphs) or none were kept, and 0 % in a traced rehearsal
on the CPU, where every chain runs eagerly."""
import pytest

import bench_tiny
from harness import discover, trace
from repro_torch.trace import Snapshot, Span

MS = 1_000_000
C0 = 1_700_000_000_000_000_000
NAMES = ("dispatch.graph_replay_pct.detect", "dispatch.graph_replay_pct.live")


class _Win:
    def __init__(self, program):
        self.program, self.trace, self.steps = program, None, 3


def _program(counts, dropped=0) -> trace.Program:
    """Three steps; each ``job.dispatch`` with the given
    ``(replays, captures, eager)``, or no counts where None."""
    spans = []
    for k, c in enumerate(counts):
        t = 10 * k + 2
        spans.append(Span(100 + 2 * k, None, "job.step", 1, t * MS,
                          (t + 5) * MS, {"step": k}))
        attrs = {"step": k}
        if c is not None:
            attrs.update(zip(("replays", "captures", "eager"), c))
        spans.append(Span(101 + 2 * k, 100 + 2 * k, "job.dispatch", 1,
                          (t + 1) * MS, (t + 2) * MS, attrs))
    first = Snapshot([], ((0, C0), (1 * MS, C0 + 1 * MS)), 0)
    last = Snapshot(spans, ((0, C0), (40 * MS, C0 + 40 * MS)), dropped)
    return trace.Program.between(first, last)


@pytest.mark.parametrize("name", NAMES)
def test_replay_share_reads_the_dispatch_counts(name):
    read = discover.reader(name)
    win = _Win(_program([(1, 1, 0), (2, 0, 0), (2, 0, 0)]))
    assert read(win) == pytest.approx(100 * 5 / 6, rel=1e-12)
    assert read(_Win(_program([(0, 0, 2)] * 3))) == 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("win", [
    _Win(None), _Win(_program([None] * 3)),
    _Win(_program([(2, 0, 0)] * 3, dropped=1)),
    _Win(_program([(0, 0, 0)] * 3))],
    ids=["no_program", "no_counts", "a_span_dropped", "no_chain_run"])
def test_replay_share_reads_nothing_without_counts(name, win):
    assert discover.reader(name)(win) is None


@pytest.mark.parametrize("cell,name", [("set2.detect", NAMES[0]),
                                       ("set1.live", NAMES[1])])
def test_traced_rehearsal_reads_no_replay_on_the_cpu(cell, name):
    out = bench_tiny.run(cell, traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"][name]["value"] == 0.0
