"""The dry run's flop count of the float32 train step with remat per
block (``launch.dryrun.count`` on ``meta`` tensors) against the
reference's ``hlo_analysis`` of its compiled step, on the reduced archs
at B = 2, S = 64 (``test_torch_dryrun.flops_pair``): exactly equal, but
for mamba2-2.7b (``TRAIN_TOL``); the hybrid is pinned as ROADMAP C14 in
test_torch_dryrun.py."""
import pytest

import repro_torch.configs as configs
from test_torch_dryrun import HYBRID, flops_pair

# The two packages' autodiff contract the SSD scan's einsums
# (models/mamba2.py) along different paths in the backward; their
# forward counts are equal.  Read: 102 432 768 against 102 727 680
# (0.29 % fewer in the port).
TRAIN_TOL = {"mamba2-2.7b": 5e-3}


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if a != HYBRID])
def test_train_step_flops_match_hlo_analysis(arch):
    got, want = flops_pair(arch, "train")
    tol = TRAIN_TOL.get(arch, 0.0)
    assert got > 0 and abs(got - want) <= tol * want, (got, want)
