"""The port's MoE feed-forward (``repro_torch.models.moe``): the
reference's tests/test_moe.py cases on the port, then the port against
the reference on the same numpy weights and inputs -- with capacity
drops (the same dropped assignments, exactly) and with stripe-local
dispatch (``rt.dp = 2``).

Tolerance: in float64 (the reference under ``reference_in_float64``)
within ``F64_TOL`` = 1e-10 of the reference's largest magnitude; in
float32 within ``F32_TOL`` = 1e-4, where the two differ by the order of
float32 sums only (top-k sets equal, as the dropped-set check shows).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunSpec as JRunSpec
from repro.models import moe as jmoe
from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.models import module, moe
from torch_lm_cases import reference_in_float64

F64_TOL, F32_TOL = 1e-10, 1e-4


def _cfgs(e=8, k=2, cap=64.0, dense=False):
    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=24, vocab=32, n_experts=e, moe_top_k=k,
              moe_capacity_factor=cap, moe_dense_residual=dense,
              moe_dense_ff=24)
    return JModelConfig(**kw), ModelConfig(**kw)


def _cfg(**kw):
    return _cfgs(**kw)[1]


def _weights(cfg, seed=0):
    """Seeded numpy weights for the defs (fan-in scaled)."""
    rng = np.random.default_rng(seed)
    return module.tree_map(
        lambda d: (rng.standard_normal(d.shape)
                   / math.sqrt(d.shape[-2])).astype(np.float32),
        moe.moe_defs(cfg, RunSpec(tp=1)))


def _params(cfg, seed=0):
    return module.tree_map(torch.as_tensor, _weights(cfg, seed))


def _x(shape, seed):
    return torch.as_tensor(
        np.random.default_rng(seed).standard_normal(shape),
        dtype=torch.float32)


def _dense_reference(p, x, cfg):
    """Loop-over-experts ground truth (no capacity), in float64."""
    p = module.tree_map(lambda t: t.double().numpy(), p)
    xt = x.double().numpy().reshape(-1, cfg.d_model)
    z = xt @ p["router"]
    scores = np.exp(z - z.max(-1, keepdims=True))
    scores /= scores.sum(-1, keepdims=True)
    eids = np.argsort(-scores, axis=-1, kind="stable")[:, : cfg.moe_top_k]
    gates = np.take_along_axis(scores, eids, -1)
    gates /= gates.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.moe_top_k):
            e = eids[t, j]
            g = xt[t] @ p["wg"][e]
            h = g / (1 + np.exp(-g)) * (xt[t] @ p["wi"][e])
            out[t] += gates[t, j] * (h @ p["wo"][e])
    return out.reshape(x.shape)


# -- the reference's tests/test_moe.py, on the port --------------------------

class TestDispatchExactness:
    @pytest.mark.parametrize("e,k", [(4, 1), (8, 2), (8, 4), (16, 2)])
    def test_matches_dense_reference_no_drops(self, e, k):
        cfg = _cfg(e=e, k=k, cap=float(e))   # capacity >= T*k: no drops
        p = _params(cfg)
        x = _x((2, 8, cfg.d_model), 1)
        got = moe.apply_moe(p, x, cfg, RunSpec(tp=1)).numpy()
        np.testing.assert_allclose(got, _dense_reference(p, x, cfg),
                                   rtol=2e-4, atol=2e-5)

    def test_dense_residual_added(self):
        cfg = _cfg(dense=True)
        p = _params(cfg)
        x = _x((1, 4, cfg.d_model), 2)
        with_res = moe.apply_moe(p, x, cfg, RunSpec(tp=1)).numpy()
        p2 = dict(p, dense=module.tree_map(torch.zeros_like, p["dense"]))
        without = moe.apply_moe(p2, x, cfg, RunSpec(tp=1)).numpy()
        assert not np.allclose(with_res, without)

    def test_capacity_drops_are_bounded(self):
        """With tiny capacity the output is a partial sum -- never NaN."""
        cfg = _cfg(e=4, k=2, cap=0.25)
        p = _params(cfg)
        x = _x((2, 16, cfg.d_model), 3)
        dropped = []
        with moe.observe(lambda r: dropped.append(int((~r.keep).sum()))):
            out = moe.apply_moe(p, x, cfg, RunSpec(tp=1)).numpy()
        assert np.isfinite(out).all()
        assert dropped[0] > 0

    def test_deterministic(self):
        cfg = _cfg()
        p = _params(cfg)
        x = _x((2, 8, cfg.d_model), 4)
        a = moe.apply_moe(p, x, cfg, RunSpec(tp=1)).numpy()
        b = moe.apply_moe(p, x, cfg, RunSpec(tp=1)).numpy()
        assert (a == b).all()


class TestAuxLoss:
    def test_balanced_router_gives_near_one(self):
        """Uniform routing => aux ~= k."""
        cfg = _cfg(e=8, k=2)
        p = dict(_params(cfg))
        p["router"] = torch.zeros_like(p["router"])     # uniform scores
        x = _x((4, 64, cfg.d_model), 5)
        aux = float(moe.aux_load_loss(p, x, cfg))
        assert abs(aux - cfg.moe_top_k) < 0.2

    def test_collapsed_router_is_penalized(self):
        cfg = _cfg(e=8, k=2)
        p = dict(_params(cfg))
        r = torch.zeros(p["router"].shape)
        r[:, 0] = 100.0
        r[:, 1] = 99.0
        p["router"] = r                                # always experts 0,1
        x = torch.abs(_x((4, 64, cfg.d_model), 6)) + 0.1
        aux = float(moe.aux_load_loss(p, x, cfg))
        assert aux > 3.0   # >> balanced value (~k=2)


# -- the port against the reference -----------------------------------------

def reference_dropped(arrays, x, jcfg, jrt):
    """The (stripe, token, expert) assignments the reference drops,
    computed with its own routing ops (``apply_moe``'s ``route``)."""
    b, s, d = x.shape
    stripes = jrt.dp if (jrt.dp > 1 and b % jrt.dp == 0) else 1
    t_loc = b * s // stripes
    c = jmoe.capacity(jcfg, jrt, t_loc)
    xt = jnp.asarray(x).reshape(stripes, t_loc, d)
    out = set()
    for si in range(stripes):
        scores = jax.nn.softmax((xt[si] @ jnp.asarray(arrays["router"]))
                                .astype(jnp.float32), axis=-1)
        _, eids = jax.lax.top_k(scores, jcfg.moe_top_k)
        flat_e = eids.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        first = jnp.searchsorted(sorted_e, sorted_e, side="left")
        pos = jnp.arange(t_loc * jcfg.moe_top_k) - first
        for j in np.flatnonzero(np.asarray(pos >= c)):
            a = int(order[j])
            out.add((si, a // jcfg.moe_top_k, int(flat_e[a])))
    return out


def port_dropped(routing):
    eids = routing.eids.reshape(routing.eids.shape[0], -1)
    k = routing.eids.shape[-1]
    out = set()
    for si, j in zip(*np.nonzero(~routing.keep.numpy())):
        a = int(routing.order[si, j])
        out.add((int(si), a // k, int(eids[si, a])))
    return out


@pytest.mark.parametrize("e,k,cap,dp,dense", [
    (8, 2, 0.5, 1, False),      # drops
    (8, 4, 0.75, 2, False),     # drops, two stripes
    (4, 2, 64.0, 2, True),      # no drops, two stripes, dense residual
    (16, 2, 1.25, 1, True),     # the default capacity factor: drops
])
def test_apply_moe_matches_reference(e, k, cap, dp, dense):
    jcfg, cfg = _cfgs(e=e, k=k, cap=cap, dense=dense)
    jrt, rt = JRunSpec(tp=1, dp=dp), RunSpec(tp=1, dp=dp)
    arrays = _weights(cfg, seed=e + k)
    x = np.random.default_rng(7).standard_normal(
        (4, 24, cfg.d_model)).astype(np.float32)
    routings = []
    with moe.observe(routings.append):
        got32 = moe.apply_moe(module.tree_map(torch.as_tensor, arrays),
                              torch.as_tensor(x), cfg, rt)
        got64 = moe.apply_moe(
            module.tree_map(lambda a: torch.as_tensor(a).double(), arrays),
            torch.as_tensor(x).double(), cfg, rt)
    want32 = jmoe.apply_moe(module.tree_map(jnp.asarray, arrays),
                            jnp.asarray(x), jcfg, jrt)
    with reference_in_float64():
        want64 = jmoe.apply_moe(
            module.tree_map(lambda a: jnp.asarray(a, jnp.float64), arrays),
            jnp.asarray(x, jnp.float64), jcfg, jrt)
    want_drop = reference_dropped(arrays, x, jcfg, jrt)
    assert port_dropped(routings[0]) == want_drop
    assert port_dropped(routings[1]) == want_drop
    assert (len(want_drop) > 0) == (cap < e)       # cap >= E: drop-free
    assert routings[0].keep.shape[0] == (dp if dp > 1 else 1)
    for got, want, tol in ((got64, want64, F64_TOL),
                           (got32, want32, F32_TOL)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
        assert err <= tol, f"{err:.3e} relative (bound {tol:.0e})"


def test_no_drop_overwrites_a_kept_slot():
    """Every drop goes to the one spare row: with one expert of capacity
    8 and 12 tokens routed to it, the first 8 (in token order) are kept,
    each in its own slot, and the last 4 contribute nothing."""
    cfg = _cfg(e=2, k=1, cap=0.1)
    p = dict(_params(cfg))
    r = torch.zeros(p["router"].shape)
    r[:, 0] = 50.0                                   # every token -> expert 0
    p["router"] = r
    x = torch.abs(_x((1, 12, cfg.d_model), 8)) + 0.1
    routings = []
    with moe.observe(routings.append):
        out = moe.apply_moe(p, x, cfg, RunSpec(tp=1))
    keep = routings[0].keep[0]
    assert moe.capacity(cfg, RunSpec(tp=1), 12) == 8
    assert keep.tolist() == [True] * 8 + [False] * 4
    assert sorted(routings[0].slot[0, :8].tolist()) == list(range(8))
    full = _dense_reference(p, x, cfg)
    np.testing.assert_allclose(out[0, :8].numpy(), full[0, :8], rtol=1e-5,
                               atol=1e-6)
    assert (out[0, 8:] == 0).all()


def test_aux_load_loss_matches_reference():
    jcfg, cfg = _cfgs(e=8, k=2)
    arrays = _weights(cfg, seed=3)
    x = np.random.default_rng(9).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    got = moe.aux_load_loss(module.tree_map(torch.as_tensor, arrays),
                            torch.as_tensor(x), cfg)
    want = jmoe.aux_load_loss(module.tree_map(jnp.asarray, arrays),
                              jnp.asarray(x), jcfg)
    assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
