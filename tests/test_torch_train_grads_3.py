"""The gradient parity of the VLM, the hybrid and the audio backbone
(see tests/test_torch_train_grads.py); every arch is in exactly one of
the three files."""
import pytest

from test_torch_train_grads import GRADS_1
from test_torch_train_grads_2 import GRADS_2
from torch_lm_cases import (ARCHS, check_bf16_loss, check_loss_grads,
                            one_torch_thread)  # noqa: F401

GRADS_3 = ["internvl2-1b", "zamba2-1.2b", "seamless-m4t-large-v2"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_every_arch_has_its_grads_checked():
    assert sorted(GRADS_1 + GRADS_2 + GRADS_3) == sorted(ARCHS)


@pytest.mark.parametrize("arch", GRADS_3)
def test_loss_grads_match_reference(arch):
    check_loss_grads(arch)


@pytest.mark.parametrize("arch", GRADS_3)
def test_bf16_loss_matches_reference(arch):
    check_bf16_loss(arch)
