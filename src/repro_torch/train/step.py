"""The training step.

``make_train_step`` returns a function
    (state, batch) -> (state, metrics)
over the train state ``{"opt": {"master", "m", "v"}, "step"[, "err"]}``
(trees of tensors; nothing is modified in place) with:
  * mixed precision: the compute params are cast from the f32 master
    each step -- at the master's own dtype a detached alias, no copy;
  * gradients from ``torch.autograd.grad`` of ``lm.loss_fn`` over the
    compute-param leaves (``RunSpec.remat == "block"`` checkpoints each
    attention block, ``models.blocks``);
  * gradient accumulation: a loop over ``rt.microbatches`` microbatches
    summing at-least-f32 grads in microbatch order, then scaled by
    1/microbatches, as the reference's ``lax.scan`` does;
  * optional cross-pod int8 error-feedback gradient compression
    (``optim.compress``) over the pods of a mesh, one device a pod;
  * the AdamW update on the master (``optim.adamw``).

Every float op runs in at least float32: a float64 state (for parity
checks) stays float64 throughout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunSpec
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import pod_devices
from repro_torch.models import lm, module
from repro_torch.models.layers import upcast
from repro_torch.models.module import leaves_with_path, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.compress import crosspod_reduce


def compute_params(master, dtype: torch.dtype, device=None):
    """Leaf tensors that require grad, cast from ``master`` (and moved to
    ``device`` when given); where nothing changes, a detached alias."""
    return tree_map(lambda a: a.detach().to(device or a.device, dtype)
                    .requires_grad_(), master)


def value_and_grad(params, batch, cfg: ModelConfig, rt: RunSpec):
    """(loss, grads) of ``lm.loss_fn`` over every leaf of ``params``
    (tensors that require grad): the grads as at-least-f32 tensors in
    ``leaves_with_path`` order, zeros for a leaf the loss does not use."""
    leaves = [t for _, t in leaves_with_path(params)]
    loss = lm.loss_fn(params, batch, cfg, rt)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), [upcast(g) for g in grads]


def _split(batch, n: int, i: int):
    """Rows ``[i*B/n, (i+1)*B/n)`` of every batch entry."""
    def rows(x):
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]
    return {k: rows(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, rt: RunSpec,
                    opt_cfg: adamw.AdamWConfig,
                    compute_dtype=torch.bfloat16,
                    batch_axes: tuple[str, ...] = ("data",),
                    compress_pod_axis: str | None = None,
                    mesh=None):
    """``batch_axes`` names the mesh axes a microbatch is laid over in the
    reference; the port runs a step on one device a pod, so only the
    default ``("data",)`` is taken, and any other raises.
    ``compress_pod_axis`` needs ``mesh``, whose axis of that name lists
    one device per pod; the batch is split over the pods in order."""
    if tuple(batch_axes) != ("data",):
        raise ValueError(f"batch_axes={batch_axes!r}: the port lays no "
                         f"batch over mesh axes; only ('data',) is taken")
    mb = rt.microbatches
    pods = (pod_devices(mesh, compress_pod_axis)
            if compress_pod_axis is not None else None)

    def grads_of(params, batch):
        """(loss, grad leaves in ``leaves_with_path`` order)."""
        if mb == 1:
            return value_and_grad(params, batch, cfg, rt)
        loss_sum, g_sum = 0.0, None
        for i in range(mb):
            loss, grads = value_and_grad(params, _split(batch, mb, i), cfg,
                                         rt)
            loss_sum = loss_sum + loss
            g_sum = grads if g_sum is None else [
                a + g for a, g in zip(g_sum, grads)]
        inv = 1.0 / mb
        return loss_sum * inv, [g * inv for g in g_sum]

    def compressed(master, batch, err):
        """Each pod's loss and grads on its device and rows of the batch,
        then ``crosspod_reduce``; the pod-mean loss."""
        n = len(pods)
        losses, grads, errs = [], [], []
        for i, dev in enumerate(pods):
            params = compute_params(master, compute_dtype, dev)
            loss, g = grads_of(params, _split(batch, n, i))
            losses.append(loss)
            grads.append(module.unflatten(master, g))
            errs.append(tree_map(lambda e, d=dev: e[i].to(d), err))
        means, new_err = crosspod_reduce(grads, errs, pods)
        home = leaves_with_path(master)[0][1].device
        loss = sum(l.to(home) for l in losses) / n
        err = tree_map(lambda *es: torch.stack([e.to(home) for e in es]),
                       *new_err)
        return loss, tree_map(lambda g: g.to(home), means[0]), err

    def train_step(state, batch):
        master = state["opt"]["master"]
        if pods is not None:
            loss, grads, err = compressed(master, batch, state["err"])
        else:
            params = compute_params(master, compute_dtype)
            loss, g = grads_of(params, batch)
            grads, err = module.unflatten(master, g), state.get("err")
        opt, metrics = adamw.apply_update(opt_cfg, state["opt"], grads,
                                          state["step"])
        new_state = {"opt": opt, "step": state["step"] + 1}
        if err is not None:
            new_state["err"] = err
        return new_state, {"loss": loss, **metrics}

    return train_step


def init_train_state(param_defs, opt_cfg, *, device="cuda", generator=None,
                     data_axes=("data",), data_size: int = 1,
                     n_pods: int = 0):
    """A real (allocated) train state on ``device`` (the card by default;
    no CPU fallback).  The master is ``module.init`` of the f32 defs
    with ``generator`` (a seed or a ``torch.Generator``, default 0); the
    moments, the step and the error-feedback residuals (``n_pods`` > 0:
    one per pod) start at zero."""
    dev = resolve_device(device)
    odefs = adamw.opt_defs(param_defs, data_axes, data_size)
    state = {"opt": {"master": module.init(odefs["master"], device=dev,
                                           generator=generator),
                     "m": module.init(odefs["m"], device=dev),
                     "v": module.init(odefs["v"], device=dev)},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if n_pods:
        state["err"] = tree_map(
            lambda d: torch.zeros((n_pods, *d.shape), dtype=torch.float32,
                                  device=dev), odefs["master"])
    return state


def _strip_pod(ps) -> list:
    out = []
    for part in ps:
        if isinstance(part, (tuple, list)):
            kept = tuple(a for a in part if a != "pod")
            out.append(kept if kept else None)
        else:
            out.append(None if part == "pod" else part)
    return out


def _err_defs(master_defs, n_pods: int):
    return tree_map(lambda d: dataclasses.replace(
        d, shape=(n_pods, *d.shape), pspec=("pod", *_strip_pod(d.pspec)),
        dtype=torch.float32), master_defs)


def abstract_train_state(param_defs, data_axes=("data",),
                         data_size: int = 1, n_pods: int = 0):
    """(tree of ``meta`` tensors, tree of partition-axis tuples) of the
    train state, without allocating it; the axes equal ``tuple()`` of
    the reference's ``PartitionSpec``s."""
    odefs = adamw.opt_defs(param_defs, data_axes, data_size)
    state_defs = {"opt": odefs}
    if n_pods:
        state_defs["err"] = _err_defs(odefs["master"], n_pods)
    shapes = module.abstract(state_defs)
    specs = module.pspecs(state_defs)
    shapes["step"] = torch.empty((), dtype=torch.int32, device="meta")
    specs["step"] = ()
    return shapes, specs


def train_state_from_numpy(param_defs, arrays, device="cuda"):
    """The train state from nested dicts of numpy arrays of its structure
    (e.g. ``jax.tree.map(np.asarray, state)`` of the reference's):
    ``{"opt": {"master", "m", "v"}, "step"[, "err"]}``.  Every path and
    shape must match the defs (``module.from_numpy``)."""
    dev = resolve_device(device)
    if set(arrays) - {"err"} != {"opt", "step"} \
            or set(arrays["opt"]) != {"master", "m", "v"}:
        raise ValueError(
            f"a train state holds opt/{{master, m, v}}, step and "
            f"optionally err; got {sorted(arrays)} with opt "
            f"{sorted(arrays.get('opt', {}))}")
    odefs = adamw.opt_defs(param_defs)
    state = {"opt": {k: module.from_numpy(odefs[k], arrays["opt"][k], dev)
                     for k in ("master", "m", "v")},
             "step": torch.tensor(np.asarray(arrays["step"]),
                                  dtype=torch.int32, device=dev)}
    if state["step"].shape != ():
        raise ValueError(f"step: shape {tuple(state['step'].shape)}, "
                         f"not a scalar")
    if "err" in arrays:
        n = np.shape(leaves_with_path(arrays["err"])[0][1])[0]
        state["err"] = module.from_numpy(_err_defs(odefs["master"], n),
                                         arrays["err"], dev)
    return state
