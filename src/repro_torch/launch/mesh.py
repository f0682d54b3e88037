"""Host meshes: a ``(data, model)`` grid of ``torch.device``s, or a
``(pod, data, model)`` one.

The counterpart of the reference's ``launch/mesh.py``.  A job laid over
a mesh (``job(...).on(mesh)``) runs one executor per data coordinate
(``distributed.partition.shard_sharding``); the model axis is
replicated.  ``make_host_mesh`` takes the first visible CUDA devices;
``device_mesh`` builds a mesh from an explicit device list, repeats
allowed, which is how one card (``["cuda:0"] * 4``) or the CPU
(``["cpu"] * 4``) hosts several executors.  A ``pod`` axis in front
(``device_mesh(devices, pod=2)``) carries the training step's cross-pod
gradient compression (``train.step.make_train_step(compress_pod_axis=
"pod")``), which runs each pod on one device (``pod_devices``).  The
production mesh of the reference belongs to its language-model scaffold
and is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """``devices``: an object array of ``torch.device`` with one axis per
    name in ``axis_names`` (``(data, model)``, or ``(pod, data, model)``);
    ``shape`` maps each axis name to its size, as a ``jax.sharding.Mesh``
    does."""

    devices: np.ndarray
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _grid(devs: list, data: int, model: int, pod: int = 1) -> HostMesh:
    grid = np.empty(pod * data * model, dtype=object)
    for i, d in enumerate(devs[:pod * data * model]):
        grid[i] = d
    if pod == 1:
        return HostMesh(grid.reshape(data, model))
    return HostMesh(grid.reshape(pod, data, model), ("pod", "data", "model"))


def device_mesh(devices, model: int = 1, pod: int = 1) -> HostMesh:
    """A ``(data=len(devices)//model, model)`` mesh over an explicit
    device list, repeats allowed (``["cpu"] * 4``, ``["cuda:0"] * 2``);
    with ``pod > 1`` a ``(pod, data=len(devices)//(pod*model), model)``
    one.  The devices must all be CPU or all CUDA."""
    devs = [torch.device(d) for d in devices]
    if not devs or model < 1 or pod < 1 or len(devs) % (model * pod):
        raise ValueError(
            f"device_mesh(model={model}, pod={pod}): {len(devs)} "
            f"device(s) cannot form a (pod={pod}, data={len(devs)}//"
            f"{max(model * pod, 1)}, model={model}) mesh — the device "
            f"count must be a positive multiple of `pod * model`")
    kinds = sorted({d.type for d in devs})
    if kinds not in (["cpu"], ["cuda"]):
        raise ValueError(f"a mesh holds CPU or CUDA devices, not both "
                         f"or others: {kinds}")
    return _grid(devs, len(devs) // (model * pod), model, pod)


def pod_devices(mesh, axis: str = "pod") -> list:
    """The device of each position along ``axis``: the pods of the
    cross-pod reduction.  Each pod runs on one device, so every other
    axis of the mesh must have size 1."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no {axis!r} axis: "
                         f"{mesh.axis_names}")
    if mesh.devices.size != mesh.shape[axis]:
        raise ValueError(
            f"each pod runs on one device, so every axis but {axis!r} "
            f"must have size 1: the mesh is {mesh.shape}")
    return list(mesh.devices.reshape(-1))


def make_host_mesh(model: int = 1, data: int | None = None) -> HostMesh:
    """Mesh over the visible CUDA devices.

    Default: all of them, split ``(data=n//model, model)``.  With
    ``data=``: a submesh over the FIRST ``data * model`` devices — how a
    scaling sweep runs the same job at 1, 2, 4, ... data shards in one
    process.  Raises, naming the requested shape, when fewer are
    visible.
    """
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = [torch.device("cuda", i) for i in range(n)]
    if model < 1 or (data is None and (n == 0 or n % model != 0)):
        raise ValueError(
            f"make_host_mesh(model={model}, data={data}): {n} visible "
            f"CUDA device(s) cannot form a (data={n}//{max(model, 1)}, "
            f"model={model}) mesh — device count must be a positive "
            f"multiple of `model`")
    if data is None:
        return _grid(devs, n // model, model)
    want = int(data) * model
    if data < 1 or want > n:
        raise ValueError(
            f"make_host_mesh(model={model}, data={data}): requested a "
            f"(data={data}, model={model}) mesh = {want} device(s) but "
            f"only {n} CUDA device(s) visible")
    return _grid(devs, int(data), model)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def data_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n
