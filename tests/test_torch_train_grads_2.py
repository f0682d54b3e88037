"""The gradient parity of the MoE archs and the SSM arch (see
tests/test_torch_train_grads.py)."""
import pytest

from torch_lm_cases import (check_bf16_loss, check_loss_grads,
                            one_torch_thread)  # noqa: F401

GRADS_2 = ["arctic-480b", "qwen3-moe-30b-a3b", "mamba2-2.7b"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", GRADS_2)
def test_loss_grads_match_reference(arch):
    check_loss_grads(arch)


@pytest.mark.parametrize("arch", GRADS_2)
def test_bf16_loss_matches_reference(arch):
    check_bf16_loss(arch)
