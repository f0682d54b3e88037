"""The dry run's flop counts (``launch.dryrun.count`` on ``meta``
tensors, ``FlopCounterMode``) against the reference's loop-aware count
of its compiled program (``distributed.hlo_analysis.analyze`` of
``jax.jit(f).lower(...).compile().as_text()``, one CPU device), on the
reduced archs at B = 2, S = 64:

  * ``lm.forward``: exactly equal for every arch but the hybrid;
  * zamba2-1.2b, forward and train step: the reference undercounts
    (ROADMAP C14), so both counts are pinned.

test_torch_dryrun_3.py holds the train steps of the other archs;
test_torch_dryrun_2.py the cells themselves: the meta count against
the CPU count, the partition axes and per-device bytes, and
``lower_cell`` and ``main``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.configs.base import RunSpec as JRunSpec
from repro.distributed import hlo_analysis
from repro.models import lm as jlm, module as jmodule
from repro.optim import adamw as jadamw
from repro.train import step as jstep
import repro_torch.configs as configs
from repro_torch.configs.base import RunSpec
from repro_torch.launch.dryrun import count
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep

B, S = 2, 64
HYBRID = "zamba2-1.2b"
# ROADMAP C14: the reference runs the hybrid's shared block under
# lax.cond (src/repro/models/lm.py:168); hlo_analysis follows calls=,
# to_apply=, condition= and body= only (distributed/hlo_analysis.py:46),
# not a conditional's branch_computations, so the shared block's dots
# count zero times.
C14 = {"forward": (122_290_176, 41_549_824),
       "train": (366_870_528, 125_042_688)}


def batch_shapes(cfg):
    """{key: (shape, numpy dtype)} of a reduced batch."""
    out = {"tokens": ((B, S), np.int32), "labels": ((B, S), np.int32),
           "mask": ((B, S), np.float32)}
    if cfg.family == "vlm":
        out["patches"] = ((B, cfg.n_frontend_tokens, cfg.frontend_dim),
                          np.float32)
    if cfg.family == "audio":
        out["frames"] = ((B, 2 * S, cfg.frontend_dim), np.float32)
    return out


def meta_batch(cfg):
    return {k: torch.empty(s, dtype=torch.from_numpy(np.zeros(0, d)).dtype,
                           device="meta")
            for k, (s, d) in batch_shapes(cfg).items()}


def reference_flops(fn, *args):
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze(hlo, 1).flops


def flops_pair(arch, kind):
    """(port's meta count, reference's count) of ``kind`` ("forward" or
    "train") at the reduced ``arch``."""
    cfg, jcfg = configs.get(arch, reduced=True), \
        jconfigs.get(arch, reduced=True)
    rt, jrt = RunSpec(tp=1, remat="block"), JRunSpec(tp=1, remat="block")
    jbatch = {k: jax.ShapeDtypeStruct(s, d)
              for k, (s, d) in batch_shapes(jcfg).items()}
    if kind == "forward":
        params = module.abstract(lm.param_defs(cfg, rt))
        with torch.no_grad():
            got, _ = count(lm.forward, params, meta_batch(cfg), cfg, rt)
        want = reference_flops(lambda p, b: jlm.forward(p, b, jcfg, jrt),
                               jmodule.abstract(jlm.param_defs(jcfg, jrt)),
                               jbatch)
        return got, want
    state, _ = trainstep.abstract_train_state(lm.param_defs(cfg, rt))
    got, _ = count(trainstep.make_train_step(
        cfg, rt, adamw.AdamWConfig(), compute_dtype=torch.float32),
        state, meta_batch(cfg))
    jstate, _ = jstep.abstract_train_state(jlm.param_defs(jcfg, jrt),
                                           ("data",), 1)
    want = reference_flops(jstep.make_train_step(
        jcfg, jrt, jadamw.AdamWConfig(), compute_dtype=jnp.float32),
        jstate, jbatch)
    return got, want


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if a != HYBRID])
def test_forward_flops_match_hlo_analysis(arch):
    got, want = flops_pair(arch, "forward")
    assert got > 0 and got == want


@pytest.mark.parametrize("kind", ["forward", "train"])
def test_hybrid_flops_pinned_as_c14(kind):
    got, want = flops_pair(HYBRID, kind)
    port, reference = C14[kind]
    assert got == port, f"the port's count moved: {got}"
    assert want == reference, (
        f"ROADMAP C14: the reference's count of the hybrid's {kind} moved "
        f"from {reference} to {want}; if its analyzer now follows "
        f"lax.cond branches it should equal the port's {got}")
    assert want < got / 2.9, "C14: the shared block counted zero times"
