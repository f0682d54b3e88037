"""The port's LM serving path against the reference in the scanned
branch of the chunked online softmax: forward and prefill over 2100
tokens (2100 encoder frames under 1050 tokens for the audio backbone),
past the one-shot limit of max(chunk, 2048) keys, with attn_chunk 512
(4 chunks and a ragged one), then a decode step over that cache.

The reference runs its layer scans op by op here (``jax.disable_jit``).
Its compiled scan body fuses the RoPE angle computation, whose cos is
then up to 7.6e-6 off at position 2100 (3e-8 op by op); these reduced
models amplify that to 3.8e-4 to 1.1e-3 relative in the logits (1.7e-2
for the audio backbone) against the op-by-op run
(scripts/reference_scan_precision.py; ROADMAP C7).  Tolerances and
weights as in tests/torch_lm_cases.py; the float64 reference runs
compiled, its scan body within 7.6e-12 of the port's float64.

The op-by-op reference takes 4-25 s an arch here, so the archs are
split over this file, tests/test_torch_lm_scanned_2.py and
tests/test_torch_lm_scanned_3.py, which ``--dist loadfile`` gives to
different workers.
"""
import pytest

from torch_lm_cases import check_serving_path

SCANNED_1 = ["minicpm3-4b", "qwen1.5-0.5b"]


@pytest.mark.parametrize("arch", SCANNED_1)
def test_scanned_serving_path_matches_reference(arch):
    check_serving_path(arch, "scanned", eager=True)
