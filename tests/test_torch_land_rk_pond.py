"""The explicit steppers ForwardEuler, SSPRK22 and SSPRK104 on the
LandModel's plain tops and on its water-only soil (kernel modes
``B6-pond@SSPRK22``, ``B6-pond-water@SSPRK104``, ...) through the kernel's
plain version, against the JAX package's fused kernel in interpret mode:
the cases of ``test_torch_land_rk.py`` (split from it so that xdist spreads
the interpret-mode runs), with ``test_torch_land_water.py``'s water-only
LandModel (T prescribed, ``TemperatureDependentViscosity``) and its rain
rows.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import pytest

from tests.test_torch_land_policies_b5 import cuda_device  # noqa: F401
from tests.test_torch_land_rk import case_id, check_rk_case, cuda_rk_matches_plain

#: (top, policy, lagged, stepper, rows, icy)
CASES = [
    ("B6-pond", "", False, "SSPRK22", None, False),
    ("B6-pond", "+B3-rate", True, "ForwardEuler", None, False),
    ("B6-step-pond", "-no-ice", False, "SSPRK104", None, True),
    ("B6-pond-water", "", False, "SSPRK104", None, False),
    ("B6-step-pond-water", "-no-ice", True, "ForwardEuler", "step", True),
]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_top_and_water_land_explicit_steppers_match_jax_fused(case):
    check_rk_case(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_plain_top_and_water_land_explicit_steppers_match_plain(cuda_device, case):  # noqa: F811
    cuda_rk_matches_plain(cuda_device, *case)
