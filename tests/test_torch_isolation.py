"""The port stands alone: no JAX, nothing of the reference package, no
silent CPU fallback, and kernel launches only on CUDA tensors."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core.manifest import DatasetManifest
from repro_torch.core.params import DepamParams
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
P = DepamParams(nfft=256, window_size=256, window_overlap=128,
                record_size_sec=0.05)
M = DatasetManifest(n_files=1, records_per_file=2, record_size=P.record_size,
                    fs=P.fs)
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.M)


def test_import_leaves_out_jax_and_reference():
    """A fresh interpreter (conftest imports jax into this one) imports
    the whole port without pulling in jax or any repro module."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.kernels.ops\n"
        "import repro_torch.core.pipeline, repro_torch.compat\n"
        "import repro_torch.kernels.events, repro_torch.data.wavio\n"
        "import repro_torch.meta, repro_torch.faults.errors\n"
        "import repro_torch.data.loader, repro_torch.launch.depam_run\n"
        "import repro_torch.launch.mesh, repro_torch.faults.resilient\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.api.formats\n"
        "import repro_torch.configs, repro_torch.models.lm\n"
        "import repro_torch.models.attention\n"
        "import repro_torch.models.moe, repro_torch.models.mamba2\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compress\n"
        "import repro_torch.train.step, repro_torch.checkpoint.manager\n"
        "import repro_torch.launch.train, repro_torch.distributed.lockstep\n"
        "import importlib.util, pathlib\n"
        "for f in sorted(pathlib.Path('examples').glob('torch_*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(f.stem, f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "[repro_torch.configs.get(a) for a in repro_torch.configs.ARCHS]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/kernels/events.py",
            "src/repro_torch/data/wavio.py",
            "src/repro_torch/data/loader.py",
            "src/repro_torch/launch/depam_run.py",
            "src/repro_torch/meta/instrument.py",
            "src/repro_torch/meta/timestamps.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/faults/resilient.py",
            "src/repro_torch/api/formats.py",
            "src/repro_torch/serve/__init__.py",
            "src/repro_torch/serve/compile_cache.py",
            "src/repro_torch/serve/live.py",
            "src/repro_torch/serve/restart.py",
            "src/repro_torch/serve/scheduler.py",
            "src/repro_torch/serve/service.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/configs/__init__.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/configs/seamless_m4t_large_v2.py",
            "src/repro_torch/models/module.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/blocks.py",
            "src/repro_torch/models/lm.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/mamba2.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/optim/compress.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/checkpoint/manager.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/distributed/lockstep.py",
            "examples/torch_quickstart.py",
            "examples/torch_soundscape_ltsa.py",
            "examples/torch_train_audio_lm.py",
            "scripts/torch_chaos_smoke.py"} <= names
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_run_without_cpu_raises_when_no_cuda(monkeypatch):
    from repro_torch import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"\.device\('cpu'\)"):
        api.job(M, P).run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_build_dir_stays_in_checkout_or_named_place(monkeypatch, tmp_path):
    """The kernel build goes under the checkout's build/ when the port
    runs from src/, to $REPRO_TORCH_BUILD when that is set, and never
    beside an installed package's site-packages."""
    from repro_torch.kernels import _build

    monkeypatch.delenv("REPRO_TORCH_BUILD", raising=False)
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path))
    assert _build.build_dir() == tmp_path
    monkeypatch.delenv("REPRO_TORCH_BUILD")
    site = tmp_path / "lib" / "site-packages" / "repro_torch" / "kernels"
    monkeypatch.setattr(_build, "__file__", str(site / "_build.py"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setattr("tempfile.tempdir", None)
    got = _build.build_dir()
    assert got.parent == tmp_path / "tmp"
    assert not got.is_relative_to(tmp_path / "lib")


def test_launch_counters_stay_zero_on_cpu():
    counters = ops.launch_counters()
    assert set(counters) == {"welch_psd", "ct_frame_psd", "welch_mean",
                             "tol_levels", "frame_psd", "detect_events"}
    before = {k: c.count for k, c in counters.items()}
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, P.record_size)),
                        dtype=torch.float32)
    welch = ops.welch_psd(x, P)
    from repro_torch.core.tol import band_matrix
    ops.tol_levels(welch, torch.as_tensor(band_matrix(P)), P)
    p2 = DepamParams(nfft=1024, window_size=1024, window_overlap=0,
                     record_size_sec=2048 / 32768)
    x2 = torch.as_tensor(rng.standard_normal((2, p2.record_size)),
                         dtype=torch.float32)
    ops.welch_psd(x2, p2)                       # ct + welch_mean
    fp = ops.frame_psd(x, P)                    # K5's plain version
    spl = torch.sum(fp, dim=-1)
    ops.detect_events(spl, torch.argmax(fp, dim=-1).to(torch.int32), P)
    from repro_torch import api
    api.job(M, P).device("cpu").run()
    (api.job(M, P).features("percentiles", "spd").events(-200.0)
     .device("cpu").run())
    assert {k: c.count for k, c in counters.items()} == before
