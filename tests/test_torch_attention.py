"""The port's attention and layers (``repro_torch.models.attention``,
``layers``) against the reference's on the same numpy inputs: the
chunked online softmax in both branches, GQA/MHA prefill and decode
with their cache writes, MLA with the absorbed decode, padded heads,
norms, MLPs and RoPE; then padded heads through the whole model.

Tolerance: 1e-5 of the reference's largest magnitude (``TOL``) for a
single layer, where the two packages differ by float32 rounding only;
the whole-model cases use tests/torch_lm_cases.py's bounds.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunSpec as JRunSpec
from repro.models import attention as jattn, layers as jlayers
from repro_torch.configs import get as get_config
from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.models import attention, layers, module
from torch_lm_cases import check_serving_path

TOL = 1e-5


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def close(got, want, tol=TOL):
    err = rel_err(got, want)
    assert err <= tol, f"{err:.3e} relative (tolerance {tol:.0e})"


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def configs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=48, n_heads=6,
                n_kv_heads=2, d_ff=64, vocab=64, head_dim=8)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def weights(defs, rng):
    """Random numpy weights for a port defs tree (biases and norm scales
    included, so every add is exercised)."""
    return module.tree_map(
        lambda d: rand(rng, *d.shape, scale=0.3 if len(d.shape) < 2
                       else 1.0 / math.sqrt(d.shape[0])) + (
            1.0 if d.init == "ones" else 0.0), defs)


def both(arrays):
    return (module.tree_map(jnp.asarray, arrays),
            module.tree_map(torch.as_tensor, arrays))


# -- the chunked online softmax ---------------------------------------------

CHUNKED = [  # (s, t, h, d, causal, q_offset, chunk, scale)
    (16, 16, 2, 8, True, 0, 1024, None),        # one shot
    (16, 16, 2, 8, False, 0, 1024, None),
    (4, 20, 3, 8, True, 16, 8, None),           # one shot, decode-like
    (12, 40, 2, 24, True, 28, 64, 1 / math.sqrt(24)),   # MLA scale
    (3000 // 100, 3000, 2, 8, False, 0, 4096, None),    # chunk > 2048
    (8, 2100, 2, 8, False, 0, 256, None),       # scanned, 2100 % 256 != 0
    (8, 2100, 2, 8, True, 2092, 256, None),     # scanned, q at the end
    (64, 2100, 2, 8, True, 0, 512, None),       # later chunks all masked
    (8, 2100, 3, 24, True, 2092, 300, 1 / math.sqrt(24)),  # MLA, scanned
]


@pytest.mark.parametrize("s,t,h,d,causal,q_offset,chunk,scale", CHUNKED)
def test_chunked_attention_matches_reference(s, t, h, d, causal, q_offset,
                                             chunk, scale):
    rng = np.random.default_rng(s * 7 + t)
    q, k, v = (rand(rng, 2, n, h, d, scale=2.0) for n in (s, t, t))
    kw = dict(causal=causal, q_offset=q_offset, chunk=chunk, scale=scale)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = attention.chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                                      torch.as_tensor(v), **kw)
    assert got.shape == (2, s, h, d)
    close(got, want)


def test_scanned_branch_equals_one_shot():
    """Same inputs through both branches of the port."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rand(rng, 1, n, 2, 8)) for n in (
        40, 2100, 2100))
    one = attention.chunked_attention(q, k, v, causal=True, q_offset=2060,
                                      chunk=4096)
    scan = attention.chunked_attention(q, k, v, causal=True, q_offset=2060,
                                       chunk=256)
    close(scan, one)


# -- GQA / MHA ---------------------------------------------------------------

ATTN = {  # name: (config overrides, RunSpec overrides)
    "gqa-bias": (dict(qkv_bias=True), {}),
    "mha": (dict(n_kv_heads=6), {}),
    "qk-norm-out-bias": (dict(qk_norm=True, attn_out_bias=True), {}),
    "gqa-tp4-pads": (dict(qkv_bias=True), dict(tp=4)),
    "uneven-gqa": (dict(n_heads=5, n_kv_heads=2), {}),
}


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_prefill_and_decode_match_reference(name):
    over, rt_over = ATTN[name]
    jcfg, cfg = configs(**over)
    jrt, rt = JRunSpec(**rt_over), RunSpec(**rt_over)
    rng = np.random.default_rng(1)
    jp, tp = both(weights(attention.attn_defs(cfg, rt), rng))
    x = rand(rng, 2, 10, cfg.d_model)
    pos = np.arange(10)[None]
    want, (jk, jv) = jattn.apply_attn(jp, jnp.asarray(x), jcfg, jrt,
                                      positions=jnp.asarray(pos))
    got, (k, v) = attention.apply_attn(tp, torch.as_tensor(x), cfg, rt,
                                       positions=torch.as_tensor(pos))
    close(got, want)
    close(k, jk)
    close(v, jv)
    assert k.shape == (2, cfg.n_kv_heads, 10, cfg.hd)

    # decode one token at slot 10 of a 12-slot cache
    pad = ((0, 0), (0, 0), (0, 2), (0, 0))
    jcache = (jnp.pad(jk, pad), jnp.pad(jv, pad))
    cache = tuple(torch.tensor(np.asarray(c)) for c in jcache)
    xt = rand(rng, 2, 1, cfg.d_model)
    want, (jk2, jv2) = jattn.decode_attn(jp, jnp.asarray(xt), jcache,
                                         jnp.int32(10), jcfg, jrt)
    got, (k2, v2) = attention.decode_attn(tp, torch.as_tensor(xt), cache, 10,
                                          cfg, rt)
    close(got, want)
    close(k2, jk2)
    close(v2, jv2)
    assert k2 is cache[0]                   # written in place


@pytest.mark.parametrize("pos", [-1, 12, 40])
def test_decode_outside_the_cache_writes_nothing(pos):
    """A position outside [0, s_max) writes no slot and does not raise;
    the output is the reference's."""
    jcfg, cfg = configs()
    rng = np.random.default_rng(2)
    jp, tp = both(weights(attention.attn_defs(cfg, RunSpec()), rng))
    kc, vc = (rand(rng, 2, cfg.n_kv_heads, 12, cfg.hd) for _ in range(2))
    xt = rand(rng, 2, 1, cfg.d_model)
    want, (jk, _) = jattn.decode_attn(
        jp, jnp.asarray(xt), (jnp.asarray(kc), jnp.asarray(vc)),
        jnp.int32(pos), jcfg, JRunSpec())
    cache = (torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy()))
    got, (k, v) = attention.decode_attn(tp, torch.as_tensor(xt), cache, pos,
                                        cfg, RunSpec())
    np.testing.assert_array_equal(k.numpy(), kc)
    np.testing.assert_array_equal(v.numpy(), vc)
    np.testing.assert_array_equal(np.asarray(jk), kc)
    close(got, want)


def test_flash_decode_local_shard_slice():
    """One shard's slice of a cache: slot ``pos`` belongs to shard 1 of
    s_loc 8, so shard 0 writes nothing; both against the reference."""
    rng = np.random.default_rng(3)
    q = rand(rng, 2, 4, 8)
    k, v = (rand(rng, 2, 2, 8, 8) for _ in range(2))
    nk, nv = (rand(rng, 2, 2, 8) for _ in range(2))
    kmap = np.array([0, 0, 1, 1])
    for shard in (0, 1):
        want = jattn.flash_decode_local(
            *map(jnp.asarray, (q, k, v, nk, nv)), 11, shard, 8, axis=None,
            kmap=jnp.asarray(kmap), scale=0.3)
        got = attention.flash_decode_local(
            *map(torch.as_tensor, (q, k.copy(), v.copy(), nk, nv)), 11, shard,
            8, kmap=torch.as_tensor(kmap), scale=0.3)
        for g, w in zip(got, want):
            close(g, w)


@pytest.mark.parametrize("heads,kv,tp", [(6, 2, 1), (6, 2, 4), (5, 2, 1),
                                         (8, 8, 3), (14, 2, 16)])
def test_kv_map_matches_reference(heads, kv, tp):
    jcfg, cfg = configs(n_heads=heads, n_kv_heads=kv)
    np.testing.assert_array_equal(
        attention.kv_map(cfg, RunSpec(tp=tp)).numpy(),
        np.asarray(jattn.kv_map(jcfg, JRunSpec(tp=tp))))


# -- MLA ---------------------------------------------------------------------

MLA = dict(n_heads=4, n_kv_heads=4, d_model=64, head_dim=16, mla=True,
           q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
           v_head_dim=16)


@pytest.mark.parametrize("tp,chunk", [(1, 1024), (3, 1024), (1, 8)])
def test_mla_prefill_and_absorbed_decode_match_reference(tp, chunk):
    jcfg, cfg = configs(**MLA)
    jrt, rt = JRunSpec(tp=tp, attn_chunk=chunk), RunSpec(tp=tp,
                                                         attn_chunk=chunk)
    rng = np.random.default_rng(4)
    jp, tp_ = both(weights(attention.attn_defs(cfg, rt), rng))
    x = rand(rng, 2, 9, cfg.d_model)
    pos = np.arange(9)[None]
    want, jc = jattn.apply_mla(jp, jnp.asarray(x), jcfg, jrt,
                               positions=jnp.asarray(pos))
    got, c = attention.apply_mla(tp_, torch.as_tensor(x), cfg, rt,
                                 positions=torch.as_tensor(pos))
    close(got, want)
    close(c, jc)
    assert c.shape == (2, 1, 9, cfg.kv_lora_rank + cfg.qk_rope_dim)

    jcache = jnp.pad(jc, ((0, 0), (0, 0), (0, 3), (0, 0)))
    cache = torch.tensor(np.asarray(jcache))
    xt = rand(rng, 2, 1, cfg.d_model)
    want, jc2 = jattn.mla_decode(jp, jnp.asarray(xt), jcache, jnp.int32(9),
                                 jcfg, jrt)
    got, c2 = attention.mla_decode(tp_, torch.as_tensor(xt), cache, 9, cfg,
                                   rt)
    close(got, want)
    close(c2, jc2)
    assert c2 is cache


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(5)
    p = {"scale": rand(rng, 32) + 1.0, "bias": rand(rng, 32)}
    x = rand(rng, 3, 7, 32, scale=4.0)
    close(layers.apply_norm(module.tree_map(torch.as_tensor, p),
                            torch.as_tensor(x), kind),
          jlayers.apply_norm(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("kind,bias", [("swiglu", False), ("gelu", True),
                                       ("gelu", False)])
def test_mlp_matches_reference(kind, bias):
    rng = np.random.default_rng(6)
    defs = layers.mlp_defs(24, 40, kind, bias)
    jp, tp = both(weights(defs, rng))
    x = rand(rng, 2, 5, 24, scale=3.0)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), kind)
    close(layers.apply_mlp(tp, torch.as_tensor(x), kind), want)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's default is
    the exact erf form, about 5e-4 away."""
    h = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(h)))
    np.testing.assert_allclose(layers.gelu(torch.as_tensor(h)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.as_tensor(h)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_rope_matches_reference():
    rng = np.random.default_rng(7)
    pos = np.array([[0, 1, 5, 511, 4095]])
    x = rand(rng, 1, 5, 3, 16)
    for theta in (1e4, 1e6):
        jc, js = jlayers.rope_angles(jnp.asarray(pos), 16, theta)
        c, s = layers.rope_angles(torch.as_tensor(pos), 16, theta)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-6)
        close(layers.apply_rope(torch.as_tensor(x), c, s),
              jlayers.apply_rope(jnp.asarray(x), jc, js))
    # split halves, not interleaved pairs: position 1 moves x[..., 0]
    # with x[..., 8]
    c, s = layers.rope_angles(torch.tensor([[1]]), 16, 1e4)
    e = torch.zeros(1, 1, 1, 16)
    e[..., 8] = 1.0
    out = layers.apply_rope(e, c, s)
    assert out[..., 0] != 0 and out[..., 1] == 0


def test_param_defs_use_plain_axis_tuples():
    _, cfg = configs(qkv_bias=True)
    defs = attention.attn_defs(cfg, RunSpec(tp=2))
    assert defs["wq"].pspec == (None, "model", None)
    assert defs["wk"].pspec == (None, "model", None)
    stacked = module.stack(defs, 3)
    assert stacked["wq"].shape == (3, 48, 6, 8)
    assert stacked["wq"].pspec == (None, None, "model", None)
    assert defs["bq"].init == "zeros"


# -- padded heads through the whole model (tests/torch_lm_cases.py's
# serving-path check and tolerances) ------------------------------------

@pytest.mark.parametrize("arch,tp", [("qwen1.5-0.5b", 4),
                                     ("internvl2-1b", 4),
                                     ("internlm2-20b", 3),
                                     ("minicpm3-4b", 3)])
def test_padded_heads_match_reference(arch, tp):
    """RunSpec(tp=4) zero-pads 6 q heads to 8 (GQA pads read kv head 0);
    the 8-head GQA and 4-head MLA configs, which 4 divides, pad to 9 and
    6 under tp=3.  The port gives the reference's logits and caches."""
    heads = get_config(arch, reduced=True).n_heads
    assert RunSpec(tp=tp).padded_heads(heads) > heads
    check_serving_path(arch, "one-shot", tp=tp)
