"""The scanned branch for two more attention archs (see
tests/test_torch_lm_scanned.py)."""
import pytest

from torch_lm_cases import check_serving_path

SCANNED_2 = ["internlm2-20b", "starcoder2-7b"]


@pytest.mark.parametrize("arch", SCANNED_2)
def test_scanned_serving_path_matches_reference(arch):
    check_serving_path(arch, "scanned", eager=True)
