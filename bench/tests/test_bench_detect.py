"""The detection cell's own parts, on the CPU.

  * its kernel costs (``costs/frame_psd.py``, ``costs/detect_events.py``)
    held to the program's model (``src/repro_torch/kernels/roofline.py``)
    of K2 and K6 at paper set 2's step of 8 records, the differences
    pinned: the per-frame PSD costs 2 bytes a raw int16 sample and a
    4-byte decode scale a record where the program counts 4 bytes a
    sample, and no frame sum, which only the Welch mean does;
  * its plain reference (``reference/detect_ref.py``) imports nothing of
    the program, of the JAX package or of JAX, in a fresh process.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

from harness import discover  # noqa: E402
from repro_torch.core.params import PARAM_SET_2  # noqa: E402
from repro_torch.kernels import roofline as program  # noqa: E402

R = 8      # records a step of the cell
P = PARAM_SET_2


def test_frame_psd_is_k2_less_the_frame_sum():
    cost = discover.costs()["frame_psd"]
    frames = R * P.frames_per_record
    k2 = program.ct_cost(frames, P)
    f32 = cost(P, (torch.zeros((R, P.record_size)), P), {})
    assert f32.bytes == k2.hbm_bytes
    assert f32.flops == k2.flops - frames * P.n_bins
    i16 = cost(P, (torch.zeros((R, P.record_size), dtype=torch.int16), P),
               {"scales": torch.ones(R)})
    assert f32.bytes - i16.bytes == 2 * R * P.record_size - 4 * R
    assert i16.flops == f32.flops
    assert i16.bound == "bytes"


def test_detect_events_is_k6():
    cost = discover.costs()["detect_events"]
    f = P.frames_per_record
    got = cost(P, (torch.zeros((R, f)), torch.zeros((R, f),
                                                    dtype=torch.int32), P),
               {})
    want = program.detect_events_cost(R, f, P.event_capacity)
    assert (got.bytes, got.flops) == (want.hbm_bytes, want.flops)
    assert got.bound == "bytes"


def test_detection_reference_imports_nothing_of_the_program():
    src = (BENCH / "reference" / "detect_ref.py").read_text()
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro|"
                     r"repro_torch)(\s|\.|$)", re.M)
    assert not pat.search(src)
    code = ("import sys; sys.path.insert(0, {b!r}); "
            "from reference import detect_ref; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(b=str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=""),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
