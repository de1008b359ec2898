"""TR-BDF2 with rate and with lagged equilibrium freeze-thaw under a MOST top
with per-column ``theta_atm`` rows (``B4-trbdf2+B3-rate+B5+B7``,
``B4-trbdf2+B2+B3-eq+B5+B7-time``, ...; ``csrc/implicit_most_kernel.cu``),
step-indexed and time-indexed, through the kernel's plain version, against
the JAX package's fused kernel in interpret mode (the cases and the bar:
``test_torch_b4_most_policies.py``; the rows:
``test_torch_land_policies_rows.py``).  The kernel is held against this
plain version on the card in ``chip_smoke.py`` phase 17a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import pytest

from tests.test_torch_b4_most_policies import ROW_POLICIES, check_implicit_case, cuda_implicit_matches_plain
from tests.test_torch_land_policies_b5 import cuda_device  # noqa: F401
from tests.test_torch_land_policies_rows import TIME_GRID


#: on the CPU each policy with one row kind (step-indexed rows with rate, time-indexed with lagged
#: equilibrium); the card holds all four pairs to the plain version
ROW_CASES = [(ROW_POLICIES[0], None), (ROW_POLICIES[1], TIME_GRID)]


@pytest.mark.parametrize("policy,time_grid", ROW_CASES, ids=["B7-+B3-rate", "B7-time-+B2+B3-eq"])
def test_trbdf2_policies_with_rows_match_jax_fused(policy, time_grid):
    check_implicit_case("trbdf2", policy, rows=True, time_grid=time_grid)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ROW_POLICIES)
@pytest.mark.parametrize("time_grid", [None, TIME_GRID], ids=["B7", "B7-time"])
def test_cuda_trbdf2_policy_instances_with_rows_match_plain(cuda_device, policy, time_grid):  # noqa: F811
    cuda_implicit_matches_plain(cuda_device, "trbdf2", policy, rows=True, time_grid=time_grid)


def test_fused_engine_runs_the_implicit_policies_under_most():
    """``Simulation(engine="fused")`` with TR-BDF2 under the MOST top with
    lagged equilibrium freeze-thaw (the plain version on the CPU) == the
    eager engine at rtol 1e-12; the stepper is the lagged coefficients around
    the projection around TR-BDF2, as the JAX kernel traces it."""
    import numpy as np

    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import TRBDF2Soil
    from landhydrology_tpu_torch.models.soil.freeze_thaw import PhaseEquilibriumStepper
    from landhydrology_tpu_torch.models.soil.lagged import LaggedCoefficientStepper
    from tests.test_torch_b4_most_policies import most_soil
    from tests.test_torch_land_policies_b5 import CHECK_NCOL, cold_state

    jm = most_soil("+B2+B3-eq", CHECK_NCOL)
    model = model_from_reference(jm, device="cpu")
    grid = make_function_space(model.domain, model.float_dtype, "cpu")
    kw = dict(Y_init=state_from_numpy(cold_state(jm), device="cpu"), Ya_init={"zc": grid.zc, "soil": {}},
              dt=60.0, tspan=(0.0, 240.0), saveat=120.0)
    eager = Simulation(model, TRBDF2Soil(model=model, grid=grid), **kw)
    fused = Simulation(model, TRBDF2Soil(model=model, grid=grid), engine="fused", steps_per_call=2, **kw)
    assert isinstance(fused.stepper, LaggedCoefficientStepper)
    assert isinstance(fused.stepper.inner, PhaseEquilibriumStepper)
    se, sf = eager.run(), fused.run()
    assert fused._fused(2).name == "B4-trbdf2+B2+B3-eq+B5"
    for k, v in se.us["soil"].items():
        np.testing.assert_allclose(sf.us["soil"][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-16, err_msg=k)
