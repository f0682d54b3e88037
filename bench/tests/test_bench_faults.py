"""The checks fail what they must, at tiny sizes on the CPU.

  * the control: the reference in TF32 (and the reduction stage in
    bfloat16) put in the program's place fails at least one number of
    every cell, on three seeds;
  * the faults a cell can have, planted under the timed path, each turn
    ``correct`` false in a whole run: a step that returns its carry
    unchanged; half of each step's records left out, the mean of the
    rest put in their place; an answer altered where it is produced; a
    step's features handed to the sink twice (the live feed's
    guarantee).  (No cell spans chips, so none can leave out an exchange
    between them.)

On the card the control is read at each cell's own size by
``bench/control.py``; PERF.md gives its readings."""
import pytest
import torch

import bench_tiny
from harness import check, discover
from repro_torch.api import engine, sinks
from repro_torch.kernels import ops

CELLS = [w["name"] for w in discover.benchmark()["workloads"]]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7, 991])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, seed):
    look = {"control": True}
    out = bench_tiny.run(name, seed=seed, inspect=look)
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    assert out["correct"], out["checks"]
    assert not check.verdict(look["control"], limits), look["control"]


def _unchanged_carry(job, monkeypatch):
    monkeypatch.setattr(engine, "compile_reduce_update",
                        lambda bindings: lambda state, *a: state)


def _half_batch(job, monkeypatch):
    """The step computes its first half of records; the other half gets
    their mean."""
    orig = ops.welch_psd

    def half(x, p, *a, **kw):
        if x.dim() == 1 or x.shape[0] < 2:
            return orig(x, p, *a, **kw)
        k = x.shape[0] // 2
        sc = kw.get("scales")
        kw2 = dict(kw, scales=None if sc is None else sc[:k])
        done = orig(x[:k], p, *a, **kw2)
        rest = done.mean(dim=0, keepdim=True).expand(
            (x.shape[0] - k,) + tuple(done.shape[1:]))
        return torch.cat([done, rest])
    monkeypatch.setattr(ops, "welch_psd", half)


def _altered_answer(job, monkeypatch):
    """One bin of every record's spectrum, 1 % off where it is made."""
    orig = ops.welch_psd

    def altered(*a, **kw):
        out = orig(*a, **kw).clone()
        out[..., 3] *= 1.01
        return out
    monkeypatch.setattr(ops, "welch_psd", altered)


def _delivered_twice(job, monkeypatch):
    """The sink receives one step of the window twice."""
    orig = sinks.CallbackSink.write

    def twice(self, step, indices, values):
        orig(self, step, indices, values)
        if step == job.stepper.step - 1 and step > 3:
            orig(self, step, indices, values)
    monkeypatch.setattr(sinks.CallbackSink, "write", twice)


def _faults(cell: str) -> list:
    """The faults the cell can have: half of a step's records left out
    needs steps of two records or more."""
    spec = discover.benchmark()
    mix = discover.mix(discover.cell(spec, cell)["traffic"])
    faults = [("unchanged_carry", _unchanged_carry),
              ("altered_answer", _altered_answer),
              ("delivered_twice", _delivered_twice)]
    if mix["chunk"] >= 2:
        faults.append(("half_batch", _half_batch))
    return [pytest.param(cell, f, id=f"{cell}-{n}") for n, f in faults]


@pytest.mark.parametrize("name,fault",
                         [f for c in CELLS for f in _faults(c)])
def test_fault_is_not_correct(name, fault, monkeypatch):
    out = bench_tiny.run(name, fault=lambda job: fault(job, monkeypatch))
    assert not out["correct"], out["checks"]
    if fault is _delivered_twice:
        assert out["failed"] > 0
