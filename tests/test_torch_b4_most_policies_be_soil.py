"""``BackwardEulerSoil`` with the step policies under a MOST top
(``B4-be-soil+B2+B5`` to ``B4-be-soil-no-ice+B2+B5``,
``csrc/implicit_most_kernel.cu``) and with lagged coefficients and no ice on
the plain soil (``B4-be-soil-no-ice+B2``, ``csrc/implicit_kernel.cu``)
through the kernel's plain version, against
the JAX package's fused kernel in interpret mode (the cases and the bar:
``test_torch_b4_most_policies.py``).  The kernel is held against this plain
version on the card in ``chip_smoke.py`` phase 17a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import pytest

from tests.test_torch_b4_most_policies import case_id, cases, check_implicit_case, cuda_implicit_matches_plain
from tests.test_torch_land_policies_b5 import cuda_device  # noqa: F401


@pytest.mark.parametrize("case", cases("be-soil"), ids=case_id)
def test_be_soil_policies_match_jax_fused(case):
    check_implicit_case(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases("be-soil"), ids=case_id)
def test_cuda_be_soil_policy_instances_match_plain(cuda_device, case):  # noqa: F811
    cuda_implicit_matches_plain(cuda_device, *case)
    if "no-ice" in case[1]:
        cuda_implicit_matches_plain(cuda_device, *case, icy_state=True)
