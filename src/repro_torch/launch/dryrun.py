"""Dry run: trace every (arch x shape x mesh) cell on ``meta`` tensors.

Per cell this script:
  1. builds the abstract train state / params / caches (``meta``
     tensors -- no allocation, which is how a 480B-param config is
     sized on any host) and their partition axes over the production
     mesh (``launch.mesh.make_production_mesh``, ``meta`` devices);
  2. runs ``train_step`` / ``prefill`` / ``decode_step`` on them once,
     under ``torch.utils.flop_counter.FlopCounterMode`` and a dispatch
     mode that sums the bytes of every aten op's operands;
  3. records the counts, the per-device argument bytes and the roofline
     terms (``distributed.roofline``) as one JSON record in
     ``<out>/<arch>__<shape>__<mesh>.json``.

The counterpart of the reference's ``launch/dryrun.py``, which compiles
each cell with XLA over 512 forced host devices and reads its cost and
memory analyses.  Eager PyTorch has no partitioner and no compiled
program, so:
  * the step runs whole, on no device: ``flops_per_device`` and
    ``hbm_bytes_per_device`` are the whole program's counts divided by
    the mesh's device count (``per_device_basis``);
  * the bytes are unfused eager traffic: the inputs and outputs of each
    aten op that is not a view, each counted where the op reads or
    writes it, as if nothing stayed in a cache between two ops;
  * ``memory.argument_bytes`` is each device's shard of the arguments,
    from their partition axes and the mesh's shape;
  * the decode cells trace ``lm.decode_step`` unsharded, over caches
    laid out on the mesh's sequence axes; the reference traces the
    sequence-sharded decode (``decode_step(..., mesh=mesh)``).  The
    products are the same; the shards' combine (a max and weighted sums
    across shards) is not traced.  Decode records say so in
    ``decode_basis``;
  * temporaries, peaks, collectives and XLA's cost analysis have no
    counterpart and are ``null``; ``compile_s`` (the reference's key)
    holds the trace's seconds.
No environment variable is set and no device is touched, whatever the
host has.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs as configs
from repro_torch.distributed import roofline
from repro_torch.launch import mesh as meshlib, shapes as shapeslib
from repro_torch.models import lm, module
from repro_torch.optim import adamw
from repro_torch.train import step as trainstep

FSDP_SERVE_THRESHOLD = 8e9   # bytes/device of TP-only bf16 params
COMPUTE_DTYPE = torch.bfloat16
PER_DEVICE_BASIS = ("whole-program count / n_devices: eager PyTorch has "
                    "no partitioner")
HBM_BYTES_BASIS = ("unfused eager traffic: inputs and outputs of every "
                   "non-view aten op")
DECODE_BASIS = ("unsharded lm.decode_step over the mesh-laid caches; the "
                "reference traces decode_step(mesh=mesh): same products, "
                "the shards' combine not traced")


class OpBytes(TorchDispatchMode):
    """Sums the bytes of every tensor an aten op reads or writes (views
    move none and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(fn, *args):
    """(flops, op bytes) of ``fn(*args)``: every product
    ``FlopCounterMode`` knows (matmuls, convolutions, attention), and
    ``OpBytes``."""
    flops = FlopCounterMode(display=False)
    ops = OpBytes()
    with flops, ops:
        fn(*args)
    return flops.get_total_flops(), ops.bytes


def shard_bytes(tensors, axes, mesh) -> int:
    """Bytes of one device's shard of every leaf of ``tensors``, laid
    out by the matching axis tuples of ``axes`` over ``mesh``."""
    def leaf(t, spec):
        n = t.element_size()
        for i, dim in enumerate(t.shape):
            part = spec[i] if i < len(spec) else None
            names = part if isinstance(part, tuple) else (
                () if part is None else (part,))
            ways = 1
            for a in names:
                ways *= mesh.shape[a]
            n *= -(-dim // ways)
        return n

    sizes = module.tree_map(leaf, tensors, axes)
    return sum(s for _, s in module.leaves_with_path(sizes))


def _abstract_params(cfg, rt, mesh, data_size):
    """bf16 compute params for serving cells, as (``meta`` tree, axes).

    TP-only sharding when the per-device footprint fits (no per-token
    weight gathers); FSDP(+TP) via the ZeRO spec transform only when a
    TP-only layout would not fit HBM (arctic-480b: 60 GB/device
    TP-only)."""
    defs = lm.param_defs(cfg, rt)
    tp_bytes = 2 * module.count_params(defs) / mesh.shape["model"]
    if tp_bytes > FSDP_SERVE_THRESHOLD:
        defs = adamw.opt_defs(defs, meshlib.data_axes(mesh),
                              data_size)["master"]
    return module.abstract(defs, dtype=COMPUTE_DTYPE), module.pspecs(defs)


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """Trace one cell on ``meta`` tensors and return its record."""
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    cfg = configs.get(arch)
    shape = shapeslib.SHAPES[shape_name]
    if not shapeslib.applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention; "
                          f"{cfg.family} is full-attention"}
    rt = shapeslib.runspec_for(cfg, shape, mesh)
    dsize = meshlib.data_size(mesh)
    n_dev = mesh.devices.size
    t0 = time.time()

    if shape.kind == "train":
        state, state_axes = trainstep.abstract_train_state(
            lm.param_defs(cfg, rt), meshlib.data_axes(mesh), dsize)
        batch, batch_axes = shapeslib.input_specs(cfg, shape, mesh)
        fn = trainstep.make_train_step(cfg, rt, adamw.AdamWConfig(),
                                       compute_dtype=COMPUTE_DTYPE)
        flops, hbm = count(fn, state, batch)
        arg_bytes = (shard_bytes(state, state_axes, mesh)
                     + shard_bytes(batch, batch_axes, mesh))
        n_tokens = shape.batch * shape.seq
    else:
        params, p_axes = _abstract_params(cfg, rt, mesh, dsize)
        inp, inp_axes = shapeslib.input_specs(cfg, shape, mesh)
        with torch.no_grad():
            if shape.kind == "prefill":
                flops, hbm = count(lm.prefill, params, inp, cfg, rt,
                                   shape.seq)
                n_tokens = shape.batch * shape.seq
            else:   # decode: the position only selects the cache slot
                flops, hbm = count(lm.decode_step, params, inp["tokens"],
                                   inp["caches"], shape.seq - 1, cfg, rt)
                n_tokens = shape.batch
        arg_bytes = (shard_bytes(params, p_axes, mesh)
                     + shard_bytes(inp, inp_axes, mesh))
    mf = roofline.model_flops(cfg, n_tokens, train=shape.kind == "train")

    flops_pd, hbm_pd = flops / n_dev, hbm / n_dev
    mf_per_dev = mf / n_dev
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_devices": n_dev,
        "compile_s": round(time.time() - t0, 1),
        "per_device_basis": PER_DEVICE_BASIS,
        "hbm_bytes_basis": HBM_BYTES_BASIS,
        **({"decode_basis": DECODE_BASIS} if shape.kind == "decode"
           else {}),
        "compute_dtype": str(COMPUTE_DTYPE).removeprefix("torch."),
        "flops_per_device": flops_pd,
        "hbm_bytes_per_device": hbm_pd,
        "collective_wire_bytes_per_device": None,
        "collective_counts": None,
        "collective_bytes_by_kind": None,
        "xla_cost_analysis": None,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": None,
                   "temp_bytes": None, "peak_bytes": None},
        "model_flops_total": mf,
        "model_flops_per_device": mf_per_dev,
        "useful_flops_ratio": mf_per_dev / flops_pd if flops_pd else None,
        **roofline.roofline_terms_per_device(flops_pd, hbm_pd, None,
                                             dtype=COMPUTE_DTYPE),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(shapeslib.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (exists)")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = lower_cell(arch, shape, mp)
        except Exception as e:   # one cell's fault is its record's
            rec = {"arch": arch, "shape": shape,
                   "mesh": "multi" if mp else "single",
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"  -> {rec['status']}"
              + (f" dominant={rec.get('dominant')}"
                 if rec.get("status") == "ok" else ""), flush=True)


if __name__ == "__main__":
    main()
