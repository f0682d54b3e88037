"""The port's optimizer and gradient compression (``repro_torch.optim``)
and the train state's layout (``train.step.abstract_train_state``)
against the reference's (``repro.optim``, ``repro.train.step``).

``crosspod_reduce`` and the compressed train step run in the reference
inside a ``shard_map`` over a pod axis; this file runs them in a
subprocess with two forced host devices (``reference_main``) and the
port's on ``["cpu"] * 2`` pods.  Their int8 payloads may differ by one
unit where a value lands on a rounding boundary, so the means are held
within one quantum (the shared scale / (127 // n), over n) and the
carried errors within one quantum.  The compressed step is held to the
reference's in float64 (the reference under ``reference_in_float64``)
within ``F64_TOL``: its master, m, v, carried errors, loss, grad_norm
and lr; in float32, m (the clipped mean gradient) and the carried
errors within one quantum.
"""
if __name__ == "__main__":
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N_PODS = 2
SHAPES = {"a": (6, 5), "b/c": (7,), "b/d": (2, 3, 4)}


def crosspod_inputs(seed=0):
    """Per-pod gradients (and carried errors) of SHAPES, stacked over the
    pods: {path: (N_PODS, *shape)}; the leaves' scales differ by 1e3."""
    rng = np.random.default_rng(seed)
    g = {p: (rng.standard_normal((N_PODS, *s)) * 10.0 ** (i - 1))
         .astype(np.float32) for i, (p, s) in enumerate(SHAPES.items())}
    e = {p: (rng.standard_normal(a.shape) * 1e-3 * np.abs(a).max())
         .astype(np.float32) for p, a in g.items()}
    return g, e


COMP_ARCH = "qwen1.5-0.5b"
COMP_OPT = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10)


def compressed_inputs():
    """The compressed step's inputs: (Case of the reduced COMP_ARCH,
    remat per block; its train state as numpy: the reference's weights
    as master, zero moments, step 0 and seeded carried errors that differ
    by pod; a batch of two rows a pod)."""
    import jax
    from torch_lm_cases import Case, make_batch, reference_params

    case = Case(COMP_ARCH, remat="block")
    master = reference_params(case.jcfg, case.jrt)
    rng = np.random.default_rng(7)
    err = jax.tree.map(lambda a: (rng.standard_normal((N_PODS, *a.shape))
                                  * 1e-5).astype(np.float32), master)
    arrays = {"opt": {"master": master,
                      "m": jax.tree.map(np.zeros_like, master),
                      "v": jax.tree.map(np.zeros_like, master)},
              "step": np.zeros((), np.int32), "err": err}
    return case, arrays, make_batch(case.cfg, b=2 * N_PODS, seed=5)


def reference_compressed_step(mesh) -> dict:
    """One step of the reference's compressed ``train_step`` on
    ``compressed_inputs``, in float32 and float64: {"<f32|f64>/<path>":
    array} over the new state and the metrics.  Its master, m and v come
    back with a leading axis of 1 (ROADMAP C12), which is dropped: the
    values are the step's."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    from repro.optim import compress as jcompress
    from repro.train import step as jstep
    from torch_lm_cases import as_jax, batch64, reference_in_float64, tree64

    case, arrays, batch = compressed_inputs()
    out = {}
    for name in ("f32", "f64"):
        f64 = name == "f64"
        ctx = (reference_in_float64(jstep, jadamw, jcompress) if f64
               else contextlib.nullcontext())
        with ctx:
            fn = jax.jit(jstep.make_train_step(
                case.jcfg, case.jrt, jadamw.AdamWConfig(**COMP_OPT),
                compute_dtype=jnp.float64 if f64 else jnp.float32,
                compress_pod_axis="pod", mesh=mesh))
            state, metrics = fn(
                jax.tree.map(jnp.asarray, tree64(arrays) if f64 else arrays),
                as_jax(batch64(batch) if f64 else batch))
            state = jax.tree.map(np.asarray, state)
        flat, _ = jax.tree.flatten_with_path(state)
        for path, a in flat:
            key = "/".join(str(k.key) for k in path)
            if key.split("/")[0] == "opt":
                assert a.shape[0] == 1, (key, a.shape)
                a = a[0]
            out[f"{name}/{key}"] = a
        for k, v in metrics.items():
            out[f"{name}/metrics/{k}"] = np.asarray(v)
    return out


def reference_main(workdir: str) -> None:
    """The reference's ``crosspod_reduce`` under ``shard_map`` on two
    devices, with and without carried errors: its means and new errors
    into ``workdir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.optim.compress import crosspod_reduce

    assert len(jax.devices()) == N_PODS
    mesh = jax.make_mesh((N_PODS,), ("pod",))
    g, e = crosspod_inputs()
    out = {}
    for with_err in (True, False):
        def body(g_, e_):
            mean, new_e = crosspod_reduce(
                {k: v[0] for k, v in g_.items()},
                {k: v[0] for k, v in e_.items()} if with_err else None,
                "pod")
            return ({k: v[None] for k, v in mean.items()},
                    {k: v[None] for k, v in new_e.items()})

        spec = {k: P("pod") for k in g}
        mean, new_e = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
            check_vma=False))({k: jnp.asarray(v) for k, v in g.items()},
                              {k: jnp.asarray(v) for k, v in e.items()})
        for k in g:
            out[f"{with_err}/mean/{k}"] = np.asarray(mean[k])
            out[f"{with_err}/err/{k}"] = np.asarray(new_e[k])
    out.update({f"step/{k}": v
                for k, v in reference_compressed_step(mesh).items()})
    np.savez(f"{workdir}/crosspod.npz", **{k.replace("/", "|"): v
                                           for k, v in out.items()})


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)


# -- the tests ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.module as jmodule  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.models import lm, module  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compress import crosspod_reduce  # noqa: E402
from repro_torch.train import step as trainstep  # noqa: E402
from torch_lm_cases import (ARCHS, F32_CAP, F64_TOL,  # noqa: E402
                            batch64, one_torch_thread,  # noqa: F401
                            reference_in_float64, rel_err, rt_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SCHED = dict(lr_peak=3e-4, warmup_steps=100, total_steps=1000, lr_min=3e-5)


def _by_path(tree, prefix=""):
    """{path: leaf} of nested dicts, tuples (partition axes) kept whole."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _reference_by_path(tree):
    is_leaf = lambda x: isinstance(x, (jmodule.ParamDef,   # noqa: E731
                                       jax.sharding.PartitionSpec))
    flat, _ = jax.tree.flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(k.key) for k in path): x for path, x in flat}


@pytest.mark.parametrize("step", [0, 50, 100, 550, 1000, 5000])
def test_schedule_matches_reference(step):
    """Warmup (0, 50), its end (100), mid-decay (550), the end of the
    decay (1000) and beyond it (5000)."""
    want = float(jadamw.schedule(jadamw.AdamWConfig(**SCHED),
                                 jnp.asarray(step, jnp.int32)))
    got = adamw.schedule(adamw.AdamWConfig(**SCHED),
                         torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=0.0)
    with reference_in_float64(jadamw):
        want64 = float(jadamw.schedule(jadamw.AdamWConfig(**SCHED),
                                       jnp.asarray(step, jnp.int32)))
    got64 = float(adamw.schedule(adamw.AdamWConfig(**SCHED), step,
                                 torch.float64))
    assert got64 == pytest.approx(want64, rel=F64_TOL, abs=0.0)
    if step >= SCHED["total_steps"]:
        assert got64 == pytest.approx(SCHED["lr_min"], rel=1e-12)


def _opt_state(seed, grad_scale):
    rng = np.random.default_rng(seed)

    def tree(f):
        return {"w": f((6, 5)), "blk": {"b": f((7,)), "k": f((2, 3, 4))}}

    state = {"master": tree(lambda s: rng.standard_normal(s)),
             "m": tree(lambda s: rng.standard_normal(s) * 1e-2),
             "v": tree(lambda s: rng.random(s) * 1e-4)}
    grads = tree(lambda s: rng.standard_normal(s) * grad_scale)
    return state, grads


@pytest.mark.parametrize("step,grad_scale", [(0, 0.01), (5, 0.01),
                                             (150, 3.0)])
def test_apply_update_matches_reference(step, grad_scale):
    """One AdamW step on the same state and grads: float64 within
    F64_TOL, float32 within 1e-6 relative; step 0 (lr 0, the first bias
    correction), in warmup, and past it with grad_scale 3.0, which
    clips."""
    state, grads = _opt_state(step, grad_scale)
    c = dict(lr_peak=1e-3, warmup_steps=10, total_steps=300)
    for dt, np_dt, tol in ((torch.float64, np.float64, F64_TOL),
                           (torch.float32, np.float32, 1e-6)):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: a.astype(np_dt), t)
        ctx = reference_in_float64(jadamw) if dt == torch.float64 \
            else jax.enable_x64(False)
        with ctx:
            want, wm = jadamw.apply_update(
                jadamw.AdamWConfig(**c),
                jax.tree.map(jnp.asarray, cast(state)),
                jax.tree.map(jnp.asarray, cast(grads)),
                jnp.asarray(step, jnp.int32))
            want = jax.tree.map(np.asarray, want)
            wm = {k: float(v) for k, v in wm.items()}
        tt = lambda t: module.tree_map(  # noqa: E731
            lambda a: torch.as_tensor(a.astype(np_dt)), t)
        got, gm = adamw.apply_update(adamw.AdamWConfig(**c), tt(state),
                                     tt(grads),
                                     torch.tensor(step, dtype=torch.int32))
        for k in ("master", "m", "v"):
            for (path, g), w in zip(module.leaves_with_path(got[k]),
                                    jax.tree.leaves(want[k])):
                assert g.dtype == dt
                assert rel_err(g.numpy(), w) <= tol, (k, path, dt)
        for k in ("grad_norm", "lr"):
            assert float(gm[k]) == pytest.approx(wm[k], rel=tol, abs=0.0), \
                (k, dt)
        if grad_scale > 1:
            assert wm["grad_norm"] > adamw.AdamWConfig().clip_norm


@pytest.mark.parametrize("data_size", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_defs_match_reference_at_full_width(arch, data_size):
    """zero1_spec through opt_defs: the master/m/v partition axes, shapes,
    inits and dtypes of every leaf equal the reference's (its
    PartitionSpecs as tuples), at published width."""
    jrt, rt = rt_pair()
    want = _reference_by_path(jadamw.opt_defs(
        jlm.param_defs(jconfigs.get(arch), jrt), ("data",), data_size))
    got = dict(module.leaves_with_path(adamw.opt_defs(
        lm.param_defs(configs.get(arch), rt), ("data",), data_size)))
    assert got.keys() == want.keys()
    for path, d in got.items():
        w = want[path]
        assert (d.shape, d.pspec, d.init) == (w.shape, tuple(w.pspec),
                                              w.init), path
        assert d.dtype == torch.float32
    if data_size > 1:     # ZeRO-1 shards some leaf over data
        assert any("data" in d.pspec for d in got.values())


def test_abstract_train_state_matches_reference():
    """qwen1.5-0.5b at published width, 16-way data and 2 pods: shapes,
    dtypes and partition axes of every leaf, all on ``meta``."""
    jrt, rt = rt_pair()
    jshapes, jspecs = jstep.abstract_train_state(
        jlm.param_defs(jconfigs.get("qwen1.5-0.5b"), jrt), ("data",), 16,
        n_pods=2)
    shapes, specs = trainstep.abstract_train_state(
        lm.param_defs(configs.get("qwen1.5-0.5b"), rt), ("data",), 16,
        n_pods=2)
    got_s, want_s = _by_path(shapes), _reference_by_path(jshapes)
    got_p, want_p = _by_path(specs), _reference_by_path(jspecs)
    assert got_s.keys() == want_s.keys() == got_p.keys() == want_p.keys()
    assert any(p.startswith("err/") for p in got_s)
    for path, t in got_s.items():
        w = want_s[path]
        assert t.is_meta and tuple(t.shape) == tuple(w.shape), path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        assert got_p[path] == tuple(want_p[path]), path
    n = sum(int(np.prod(t.shape)) for p, t in got_s.items()
            if p.startswith("opt/master/"))
    assert n == module.count_params(lm.param_defs(configs.get(
        "qwen1.5-0.5b"), rt))


def test_train_state_from_numpy_checks_structure():
    cfg = configs.get("qwen1.5-0.5b", reduced=True)
    defs = lm.param_defs(cfg, rt_pair()[1])
    state = trainstep.init_train_state(defs, adamw.AdamWConfig(),
                                       device="cpu", n_pods=2)
    arrays = module.tree_map(lambda t: t.numpy(), state)
    back = trainstep.train_state_from_numpy(defs, arrays, "cpu")
    for (p, a), (q, b) in zip(module.leaves_with_path(state),
                              module.leaves_with_path(back)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="opt/"):
        trainstep.train_state_from_numpy(defs, {"opt": arrays["opt"]},
                                         "cpu")
    arrays["opt"]["m"]["embed"]["table"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed/table: shape"):
        trainstep.train_state_from_numpy(defs, arrays, "cpu")


@pytest.fixture(scope="module")
def reference_crosspod(tmp_path_factory):
    work = tmp_path_factory.mktemp("crosspod_reference")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(work)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(work / "crosspod.npz") as z:
        return {k.replace("|", "/"): z[k] for k in z.files}


def _nest(flat):
    out = {}
    for path, a in flat.items():
        *keys, last = path.split("/")
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[last] = a
    return out


@pytest.mark.parametrize("with_err", [True, False])
def test_crosspod_reduce_matches_reference(reference_crosspod, with_err):
    g, e = crosspod_inputs()
    devices = ["cpu"] * N_PODS
    grads = [_nest({k: torch.as_tensor(v[i]) for k, v in g.items()})
             for i in range(N_PODS)]
    errs = ([_nest({k: torch.as_tensor(v[i]) for k, v in e.items()})
             for i in range(N_PODS)] if with_err else None)
    means, new_err = crosspod_reduce(grads, errs, devices)
    lim = 127 // N_PODS
    for path in g:
        gf = g[path] + (e[path] if with_err else 0.0)
        quantum = np.float32(np.abs(gf).max()) / lim
        want_mean = reference_crosspod[f"{with_err}/mean/{path}"]
        want_err = reference_crosspod[f"{with_err}/err/{path}"]
        for i in range(N_PODS):
            mean = dict(module.leaves_with_path(means[i]))[path].numpy()
            err = dict(module.leaves_with_path(new_err[i]))[path].numpy()
            assert np.abs(mean - want_mean[i]).max() <= quantum / N_PODS \
                * (1 + 1e-6), path
            assert np.abs(err - want_err[i]).max() <= quantum * (1 + 1e-6), \
                path
            # the mean is the same on every pod; the error is each pod's
            np.testing.assert_array_equal(
                mean, dict(module.leaves_with_path(means[0]))[path].numpy())
            # error feedback: what was sent plus what is carried is g + e
            assert np.abs(gf[i] - err).max() <= np.abs(gf).max() * (1 + 1e-6)


def _cast(tree, dtype):
    return module.tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                           else t, tree)


def _pod_quanta(case, state, batch):
    """{path: the leaf's quantum}: the largest |g + e| over the pods,
    each pod's grads (float64) on its rows of ``batch``, / (127 // n)."""
    params = trainstep.compute_params(state["opt"]["master"], torch.float64)
    rows = batch["tokens"].shape[0] // N_PODS
    scale = {}
    for i in range(N_PODS):
        _, g = trainstep.value_and_grad(
            params, {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()},
            case.cfg, case.rt)
        for (path, e), gi in zip(module.leaves_with_path(state["err"]), g):
            top = float((gi + e[i]).abs().max())
            scale[path] = max(scale.get(path, 0.0), top)
    return {p: s / (127 // N_PODS) for p, s in scale.items()}


def _compressed_port_step(case, state, batch, dtype):
    from repro_torch.launch.mesh import device_mesh

    fn = trainstep.make_train_step(
        case.cfg, case.rt, adamw.AdamWConfig(**COMP_OPT), dtype,
        compress_pod_axis="pod",
        mesh=device_mesh(["cpu"] * N_PODS, pod=N_PODS))
    return fn(_cast(state, dtype), batch64(batch)
              if dtype == torch.float64 else batch)


@pytest.fixture(scope="module")
def compressed_case():
    """(case, port state (float32), batch, quanta by path)."""
    case, arrays, batch = compressed_inputs()
    state = trainstep.train_state_from_numpy(
        lm.param_defs(case.cfg, case.rt), arrays, "cpu")
    return case, state, batch, _pod_quanta(
        case, _cast(state, torch.float64), batch64(batch))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compressed_step_matches_reference(reference_crosspod,
                                           compressed_case, dtype):
    """One compressed step over ["cpu"] * 2 pods against the reference's
    under ``shard_map`` on two devices, from the same state (carried
    errors that differ by pod) and batch.  Float64: master, m, v and the
    carried errors (each a whole tree, against its largest magnitude),
    loss, grad_norm and lr within F64_TOL.  Float32: loss and grad_norm
    within F32_CAP; m, which is (1 - b1) times the clipped mean gradient,
    within (1 - b1) clip of one quantum of each entry, and the carried
    errors within one quantum (a payload may round the other way)."""
    case, state, batch, quanta = compressed_case
    dt = getattr(torch, dtype)
    got, gm = _compressed_port_step(case, state, batch, dt)
    tag = "step/" + ("f64/" if dt == torch.float64 else "f32/")
    want = {k[len(tag):]: v for k, v in reference_crosspod.items()
            if k.startswith(tag)}
    assert int(got["step"]) == int(want["step"]) == 1
    leaves = {k: dict(module.leaves_with_path(got[k] if k == "err"
                                              else got["opt"][k]))
              for k in ("master", "m", "v", "err")}
    for k, by_path in leaves.items():
        prefix = "err/" if k == "err" else f"opt/{k}/"
        ref = {p[len(prefix):]: a for p, a in want.items()
               if p.startswith(prefix)}
        assert by_path.keys() == ref.keys(), k
        for p, t in by_path.items():
            assert t.dtype == dt and tuple(t.shape) == ref[p].shape, (k, p)
        if dt == torch.float64:
            dev = max(float(np.abs(t.numpy() - ref[p]).max())
                      for p, t in by_path.items())
            top = max(float(np.abs(a).max()) for a in ref.values())
            assert dev <= F64_TOL * top, (k, dev / top)
    for k in ("loss", "grad_norm", "lr"):
        bound = F64_TOL if dt == torch.float64 else F32_CAP
        err = rel_err(float(gm[k]), want[f"metrics/{k}"])
        assert err <= bound, (k, dtype, err)
    if dt == torch.float32:
        opt = adamw.AdamWConfig(**COMP_OPT)
        clip = min(1.0, opt.clip_norm / float(want["metrics/grad_norm"]))
        for p, t in leaves["m"].items():
            dev = float(np.abs(t.numpy() - want[f"opt/m/{p}"]).max())
            assert dev <= (1 - opt.b1) * clip * quanta[p] * (1 + 1e-3), p
        for p, t in leaves["err"].items():
            dev = float(np.abs(t.numpy() - want[f"err/{p}"]).max())
            assert dev <= quanta[p] * (1 + 1e-3), p


def test_compressed_step_against_uncompressed(compressed_case):
    """The compressed step over ["cpu"] * 2 pods against the port's
    uncompressed one on the same state and batch, in float64.  Error
    feedback loses nothing: what the pods sent (the quantized mean) plus
    the mean of what they carry forward, less the mean of what they
    carried in, is the full batch's gradient (each read from m, which is
    (1 - b1) times the clipped gradient at zero moments), within F64_TOL
    of its largest magnitude.  Each carried error is within half a
    quantum of zero; the loss is the pod mean, which equals the full
    batch's (equal rows, full masks)."""
    case, state, batch, quanta = compressed_case
    opt = adamw.AdamWConfig(**COMP_OPT)
    s1, m1 = _compressed_port_step(case, state, batch, torch.float64)
    plain = {k: v for k, v in _cast(state, torch.float64).items()
             if k != "err"}
    s0, m0 = trainstep.make_train_step(case.cfg, case.rt, opt,
                                       torch.float64)(plain, batch64(batch))
    assert rel_err(float(m1["loss"]), float(m0["loss"])) <= F64_TOL

    def grad(s, m):
        clip = min(1.0, opt.clip_norm / float(m["grad_norm"]))
        return dict(module.leaves_with_path(module.tree_map(
            lambda t: t / ((1 - opt.b1) * clip), s["opt"]["m"])))

    sent, full = grad(s1, m1), grad(s0, m0)
    err_in = dict(module.leaves_with_path(_cast(state["err"],
                                                torch.float64)))
    err_out = dict(module.leaves_with_path(s1["err"]))
    top = max(float(g.abs().max()) for g in full.values())
    for p, g in full.items():
        rebuilt = sent[p] + err_out[p].mean(0) - err_in[p].mean(0)
        assert float((rebuilt - g).abs().max()) <= F64_TOL * top, p
        assert float(err_out[p].abs().max()) <= quanta[p] / 2 * (1 + 1e-9), p
        assert err_out[p].shape == err_in[p].shape, p
    assert int(s1["step"]) == 1
