"""The per-arch parity tests of the LM serving path for the MoE archs
(see tests/torch_lm_cases.py for the cases and bounds)."""
import pytest

from torch_lm_cases import (FAMILY_FILES, check_card_matches_cpu,
                            check_loss, check_prefill_then_decode,
                            check_serving_path, check_stack_layer_by_layer)

ARCHS = FAMILY_FILES["moe"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_path_matches_reference(arch):
    """One-shot attention (tests/test_torch_lm_scanned*.py take the
    scanned branch)."""
    check_serving_path(arch, "one-shot")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    check_prefill_then_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_input_drives_the_stack_layer_by_layer(arch):
    check_stack_layer_by_layer(arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(arch):
    check_card_matches_cpu(arch)
