"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each in seconds.  At first use every source is compiled to an
object file by its own ``nvcc`` process — all started together — and
the objects are linked into one shared library, which ``ctypes``
loads.  The library lives in :func:`build_dir` (``build/repro_torch/``
at the root of a checkout), named by a hash of the sources and flags,
so an edit to any source or flag rebuilds and an unchanged tree reuses
the build.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def build_dir() -> Path:
    """Where the library is built: ``$REPRO_TORCH_BUILD`` if set, else
    ``build/repro_torch/`` at the root of the checkout when the package
    runs from its ``src/`` tree, else a per-user directory under the
    temporary directory (an installed package never writes beside
    site-packages)."""
    if os.environ.get("REPRO_TORCH_BUILD"):
        return Path(os.environ["REPRO_TORCH_BUILD"])
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    return Path(tempfile.gettempdir()) / f"repro_torch-build-{os.getuid()}"

# -use_fast_math stays off: log10f and exact f32 rounding matter for
# the tolerances, and the int16 path relies on an uncontracted multiply.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float | None     # None when an existing build was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/*.cu at first use and need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """Compile every source in parallel, link, and atomically move the
    library to ``out`` (concurrent builds each use a private
    temporary directory, so the rename is the only shared step)."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out.parent))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        so = tmp / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so),
             *(str(obj) for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def library() -> KernelLibrary:
    """The kernel library, built on the first call in a process."""
    out = build_dir() / f"libdepam_kernels-{_key()}.so"
    seconds = None
    if not out.exists():
        t0 = time.perf_counter()
        _compile(out)
        seconds = time.perf_counter() - t0
    return KernelLibrary(ctypes.CDLL(str(out)), out, seconds)


@functools.cache
def function(name: str, *argtypes) -> ctypes._CFuncPtr:
    """One C entry point with its argument types declared; every entry
    point returns the ``cudaError_t`` of its launch as an int."""
    fn = getattr(library().lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
L = ctypes.c_longlong
F = ctypes.c_float
