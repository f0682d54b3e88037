"""The gradients of the port's ``loss_fn`` against
``jax.value_and_grad`` of the reference's, arch by arch, on the same
weights (tests/torch_lm_cases.py: ``check_loss_grads``, its bounds and
readings), and the loss at bf16 compute (``check_bf16_loss``).  The
archs are split over this file and
tests/test_torch_train_grads_{2,3}.py, which ``--dist loadfile`` gives
to different workers."""
import pytest

from torch_lm_cases import (check_bf16_loss, check_loss_grads,
                            one_torch_thread)  # noqa: F401

GRADS_1 = ["minicpm3-4b", "internlm2-20b", "starcoder2-7b", "qwen1.5-0.5b"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch", GRADS_1)
def test_loss_grads_match_reference(arch):
    check_loss_grads(arch)


@pytest.mark.parametrize("arch", GRADS_1)
def test_bf16_loss_matches_reference(arch):
    check_bf16_loss(arch)
