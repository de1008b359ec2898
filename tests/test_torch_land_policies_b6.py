"""The step policies on a LandModel under a MOST top (kernel mode B6 with
freeze-thaw or ``assume_no_ice``, each alone or with lagged coefficients,
with the exchange per stage and frozen per step: ``B6+B3-rate`` to
``B2+B6-step-no-ice``) through the kernel's plain version, against the JAX
package's fused kernel in interpret mode, f64 rtol 1e-12 (the cases and the
bar: ``test_torch_land_policies_b5.py``).  The kernel is held against this
plain version on the card in ``chip_smoke.py`` phase 16a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import pytest

from tests.test_torch_land_policies_b5 import case_id, cases, check_case, cuda_device, cuda_matches_plain  # noqa: F401


@pytest.mark.parametrize("case", cases(("B6", "B6-step")), ids=case_id)
def test_most_land_model_matches_jax_fused(case):
    check_case(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases(("B6", "B6-step")), ids=case_id)
def test_cuda_most_land_policy_instances_match_plain(cuda_device, case):  # noqa: F811
    cuda_matches_plain(cuda_device, *case)
    if case[1] == "-no-ice":
        cuda_matches_plain(cuda_device, *case, icy=True)
