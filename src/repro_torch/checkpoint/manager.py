"""Async, atomic, elastic checkpointing for training state.

Layout (the reference's, so that a checkpoint written by either package
restores in the other):
  <root>/step_000123.tmp/...   (in-flight writes)
  <root>/step_000123/leaf_<i>.npy + tree.json
  <root>/LATEST                (atomic pointer file)

Leaves are numbered in ``module.leaves_with_path`` order, which is the
reference's tree-flatten order (dict keys sorted).

Properties:
  * async -- device->host transfer happens on the caller thread, file IO
    on a background thread; ``wait()`` joins before the next save
    (double buffering depth 1);
  * atomic -- directory rename + LATEST pointer rewrite; a crash
    mid-save leaves the previous checkpoint intact;
  * elastic -- leaves are stored whole, so a restore can place them on
    any device: each leaf goes to its template leaf's device, or to the
    device given.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import leaves_with_path, unflatten


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---------------- save ----------------
    def save(self, step: int, state) -> None:
        self.wait()
        host = [t.detach().to("cpu", copy=True).numpy()
                for _, t in leaves_with_path(state)]

        def _write():
            tag = f"step_{step:08d}"
            tmp = os.path.join(self.root, tag + ".tmp")
            final = os.path.join(self.root, tag)
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump({"n_leaves": len(host), "step": step}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)                 # atomic publish
            ptr = os.path.join(self.root, "LATEST.tmp")
            with open(ptr, "w") as f:
                f.write(tag)
                f.flush()
                os.fsync(f.fileno())
            os.replace(ptr, os.path.join(self.root, "LATEST"))
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        tags = sorted(t for t in os.listdir(self.root)
                      if t.startswith("step_") and not t.endswith(".tmp"))
        for t in tags[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, t), ignore_errors=True)

    # ---------------- restore ----------------
    def latest_step(self) -> int | None:
        try:
            with open(os.path.join(self.root, "LATEST")) as f:
                return int(f.read().strip().split("_")[1])
        except (FileNotFoundError, IndexError, ValueError):
            return None

    def restore(self, template, device=None) -> tuple:
        """Restore the latest checkpoint into the structure and dtypes of
        ``template`` (a tree of tensors, ``meta`` ones included): each
        leaf on ``device`` when given, else on its template leaf's device
        -- the card for a ``meta`` leaf (no CPU fallback).  Returns
        (tree, step), or (None, None) when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.root, f"step_{step:08d}")
        leaves = leaves_with_path(template)
        with open(os.path.join(path, "tree.json")) as f:
            n = json.load(f)["n_leaves"]
        if n != len(leaves):
            raise ValueError(f"{path} holds {n} leaves; the template has "
                             f"{len(leaves)}")
        dev = resolve_device(device) if device is not None else None
        out = []
        for i, (name, tmpl) in enumerate(leaves):
            a = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"{name}: stored shape {tuple(a.shape)}, "
                                 f"template {tuple(tmpl.shape)}")
            to = dev or (resolve_device("cuda") if tmpl.is_meta
                         else tmpl.device)
            out.append(torch.from_numpy(a).to(to, tmpl.dtype))
        return unflatten(template, out), step
