"""The scanned branch for two more attention archs (see
tests/test_torch_lm_scanned.py); tests/test_torch_lm_scanned_4.py takes
the MoE and hybrid archs."""
import pytest

from torch_lm_cases import check_serving_path

SCANNED_3 = ["internvl2-1b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", SCANNED_3)
def test_scanned_serving_path_matches_reference(arch):
    check_serving_path(arch, "scanned", eager=True)
