"""The scanned branch for the last two attention archs (see
tests/test_torch_lm_scanned.py)."""
import pytest

from test_torch_lm_scanned import SCANNED_1
from test_torch_lm_scanned_2 import SCANNED_2
from test_torch_models import ARCHS, check_serving_path


@pytest.mark.parametrize(
    "arch", [a for a in ARCHS if a not in SCANNED_1 + SCANNED_2])
def test_scanned_serving_path_matches_reference(arch):
    check_serving_path(arch, "scanned", eager=True)
