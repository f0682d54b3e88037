"""The port's Mamba2 SSD blocks (``repro_torch.models.mamba2``): the
reference's TestSSDOracle on the port (the chunked scan against the
naive sequential recurrence; prefill then decode against a long
prefill, at s = 17, not a multiple of the chunk), then ``apply_mamba``
and ``mamba_decode``, caches included, against the reference's on the
same numpy weights and inputs.

Tolerance: in float64 (the reference under ``reference_in_float64``)
within ``F64_TOL`` = 1e-10 of the reference's largest magnitude, leaf
by leaf; in float32 within ``F32_TOL`` = 1e-4.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunSpec as JRunSpec
from repro.models import mamba2 as jmamba2
from repro_torch.configs import get as get_config
from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.models import lm, mamba2, module
from torch_lm_cases import make_batch, reference_in_float64

F64_TOL, F32_TOL = 1e-10, 1e-4
RT = RunSpec(tp=1, remat="none", attn_chunk=64)


def _ref_ssd(x, dt, A, bb, cc):
    """Naive sequential recurrence (no D-skip: compared pre-skip)."""
    b, s, nh, hd = x.shape
    ds = bb.shape[-1]
    st = np.zeros((b, nh, ds, hd))
    ys = []
    for t in range(s):
        a_t = np.exp(dt[:, t] * A)[:, :, None, None]
        st = st * a_t + np.einsum(
            "bd,bhe->bhde", bb[:, t], x[:, t] * dt[:, t][..., None])
        ys.append(np.einsum("bd,bhde->bhe", cc[:, t], st))
    return np.stack(ys, axis=1), st


class TestSSDOracle:
    """Chunked SSD == naive sequential state-space recurrence."""

    @pytest.mark.parametrize("chunk,s", [(4, 16), (8, 16), (16, 16), (8, 12)])
    def test_chunked_matches_sequential(self, chunk, s):
        rng = np.random.default_rng(chunk + s)
        b, nh, hd, ds = 2, 3, 4, 5
        x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
        dt = rng.uniform(0.1, 0.9, (b, s, nh)).astype(np.float32)
        A = -rng.uniform(0.5, 1.5, nh).astype(np.float32)
        bb = rng.standard_normal((b, s, ds)).astype(np.float32)
        cc = rng.standard_normal((b, s, ds)).astype(np.float32)

        want, want_state = _ref_ssd(x, dt, A, bb, cc)
        a = dt * A[None, None]                     # log-decay (<= 0)
        xbar = x * dt[..., None]
        got, got_state = mamba2.ssd_chunked(
            *(torch.as_tensor(t) for t in (a, xbar, bb, cc)), chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got_state.numpy(), want_state, rtol=2e-4,
                                   atol=2e-4)

    @pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
    def test_prefill_then_decode_matches_long_prefill(self, arch):
        cfg = get_config(arch, reduced=True)
        s = 17
        batch = make_batch(cfg, s=s)
        params = module.init(lm.param_defs(cfg, RT), device="cpu")
        full = lm.forward(params, batch, cfg, RT)
        pb = dict(batch, tokens=batch["tokens"][:, : s - 2])
        _, caches = lm.prefill(params, pb, cfg, RT, s_max=s)
        logits = None
        for i in (s - 2, s - 1):
            logits, caches = lm.decode_step(
                params, batch["tokens"][:, i: i + 1], caches, i, cfg, RT)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                                   rtol=2e-2, atol=2e-3)


def test_masked_decay_discards_overflow():
    """Steep decays overflow exp(li - lj) above the diagonal to inf; the
    masked select discards it, so every output stays finite."""
    rng = np.random.default_rng(3)
    b, s, nh, hd, ds = 1, 32, 2, 4, 3
    a = torch.full((b, s, nh), -200.0)            # exp(200 * 31) = inf
    xbar = torch.as_tensor(rng.standard_normal((b, s, nh, hd)),
                           dtype=torch.float32)
    bb, cc = (torch.as_tensor(rng.standard_normal((b, s, ds)),
                              dtype=torch.float32) for _ in range(2))
    y, st = mamba2.ssd_chunked(a, xbar, bb, cc, 16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    # with no decay carried, each step sees only its own input
    want = torch.einsum("bsd,bsd,bshe->bshe", cc, bb, xbar)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the port against the reference -----------------------------------------

def _cfgs(chunk=8):
    kw = dict(name="m", family="ssm", n_layers=1, d_model=24, n_heads=1,
              n_kv_heads=1, d_ff=0, vocab=32, ssm_state=6, ssm_headdim=8,
              ssm_chunk=chunk)
    return JModelConfig(**kw), ModelConfig(**kw)


def _weights(cfg, seed):
    """Seeded numpy weights; the zero/one-initialised leaves perturbed so
    that every term (dt bias, decay, skip, norm scale) is exercised."""
    rng = np.random.default_rng(seed)

    def make(d):
        if d.init != "normal":
            base = 1.0 if d.init == "ones" else 0.0
            return (base + 0.3 * rng.standard_normal(d.shape)).astype(
                np.float32)
        std = d.scale if d.scale is not None else 1 / math.sqrt(d.shape[-2])
        return (std * rng.standard_normal(d.shape)).astype(np.float32)

    return module.tree_map(make, mamba2.mamba_defs(cfg, RunSpec(tp=1)))


def _cache(cfg, b, rng):
    st = rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_headdim))
    conv = (rng.standard_normal((b, cfg.ssm_conv - 1, cfg.ssm_heads,
                                 cfg.ssm_headdim)),
            rng.standard_normal((b, cfg.ssm_conv - 1, cfg.ssm_state)),
            rng.standard_normal((b, cfg.ssm_conv - 1, cfg.ssm_state)))
    return (st.astype(np.float32),
            tuple(c.astype(np.float32) for c in conv))


def _leaves(out):
    y, (st, conv) = out
    return [np.asarray(t, np.float64) for t in (y, st, *conv)]


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        assert g.shape == w.shape, (what, i)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, f"{what} leaf {i}: {err:.3e} (bound {tol:.0e})"


def _both(fn_port, fn_ref, arrays, args):
    """(port, reference) outputs in float32 and float64 of ``fn(arrays,
    *args)`` (``None`` arguments passed as they are)."""
    def conv(fn, tree):
        return module.tree_map(lambda a: None if a is None else fn(a), tree)

    out = {}
    for dt, tdt in (("f32", torch.float32), ("f64", torch.float64)):
        inp = (arrays, *args)
        if dt == "f64":
            inp = conv(lambda a: a.astype(np.float64), inp)
        got = fn_port(*conv(lambda a: torch.as_tensor(a, dtype=tdt), inp))
        if dt == "f64":
            with reference_in_float64():
                want = fn_ref(*conv(jnp.asarray, inp))
        else:
            want = fn_ref(*conv(jnp.asarray, inp))
        out[dt] = (module.tree_map(lambda t: t.numpy(), got), want)
    return out


@pytest.mark.parametrize("s,chunk,with_cache", [
    (16, 8, False), (13, 8, False), (13, 8, True), (5, 8, True)])
def test_apply_mamba_matches_reference(s, chunk, with_cache):
    jcfg, cfg = _cfgs(chunk)
    rng = np.random.default_rng(s + chunk)
    arrays = _weights(cfg, s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    cache = _cache(cfg, 2, rng) if with_cache else None
    jrt = JRunSpec(tp=1)

    out = _both(lambda p, xi, c: mamba2.apply_mamba(p, xi, cfg, RT, c),
                lambda p, xi, c: jmamba2.apply_mamba(p, xi, jcfg, jrt, c),
                arrays, (x, cache))
    _close(*out["f64"], F64_TOL, "float64")
    _close(*out["f32"], F32_TOL, "float32")


def test_mamba_decode_matches_reference():
    """Two decode steps from a random state, caches included."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(11)
    arrays = _weights(cfg, 2)
    cache = _cache(cfg, 3, rng)
    jrt = JRunSpec(tp=1)
    xs = rng.standard_normal((2, 3, 1, cfg.d_model)).astype(np.float32)

    def two(step):
        def run(p, x, c):
            out, c = step(p, x[0], c)
            return step(p, x[1], c)
        return run

    out = _both(two(lambda p, x, c: mamba2.mamba_decode(p, x, c, cfg, RT)),
                two(lambda p, x, c: jmamba2.mamba_decode(p, x, c, jcfg,
                                                         jrt)),
                arrays, (xs, cache))
    _close(*out["f64"], F64_TOL, "float64")
    _close(*out["f32"], F32_TOL, "float32")


def test_init_cache_layout():
    """(B, nh, ds, hd) state and (B, conv-1, ...) conv states, as the
    reference's; the state at least float32."""
    jcfg, cfg = _cfgs()
    want = jmamba2.init_cache(jcfg, 3)
    got = mamba2.init_cache(cfg, 3, dtype=torch.bfloat16)
    flat = [got[0], *got[1]]
    assert [tuple(t.shape) for t in flat] == [
        tuple(w.shape) for w in (want[0], *want[1])]
    assert got[0].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for t in got[1])
    assert all(not t.any() for t in flat)
