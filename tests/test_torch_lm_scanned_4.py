"""The scanned branch for the MoE archs and the hybrid's shared
attention sites (see tests/test_torch_lm_scanned.py); the SSM arch has
no attention, so no branch to take.  Every arch with attention is in
exactly one of the four files."""
import pytest

from test_torch_lm_scanned import SCANNED_1
from test_torch_lm_scanned_2 import SCANNED_2
from test_torch_lm_scanned_3 import SCANNED_3
from torch_lm_cases import ATTN_ARCHS, check_serving_path

SCANNED_4 = [a for a in ATTN_ARCHS
             if a not in SCANNED_1 + SCANNED_2 + SCANNED_3]


def test_every_attention_arch_takes_the_scanned_branch():
    assert sorted(SCANNED_1 + SCANNED_2 + SCANNED_3 + SCANNED_4) \
        == sorted(ATTN_ARCHS)
    assert SCANNED_4 == ["arctic-480b", "qwen3-moe-30b-a3b", "zamba2-1.2b"]


@pytest.mark.parametrize("arch", SCANNED_4)
def test_scanned_serving_path_matches_reference(arch):
    check_serving_path(arch, "scanned", eager=True)
