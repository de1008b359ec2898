"""The step policies on a LandModel under a plain top BC (kernel mode
B6-pond with freeze-thaw or ``assume_no_ice``, each alone or with lagged
coefficients, with the exchange per stage and frozen per step:
``B6-pond+B3-rate`` to ``B2+B6-step-pond-no-ice``) through the kernel's
plain version, against the JAX package's fused kernel in interpret mode, f64
rtol 1e-12 (the cases and the bar: ``test_torch_land_policies_b5.py``), and
``Simulation(engine="fused")`` with the policies wrapped around SSPRK33 as
for the eager engine.  The kernel is held against this plain version on the
card in ``chip_smoke.py`` phase 16a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import numpy as np
import pytest
import torch

from landhydrology_tpu_torch import Simulation
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy
from landhydrology_tpu_torch.models.land import FrozenExchangeStepper
from landhydrology_tpu_torch.models.soil.freeze_thaw import PhaseEquilibriumStepper
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_torch_land_policies_b5 import (  # noqa: F401
    case_id, cases, check_case, cold_state, cuda_device, cuda_matches_plain, jax_model,
)


@pytest.mark.parametrize("case", cases(("B6-pond", "B6-step-pond")), ids=case_id)
def test_pond_land_model_matches_jax_fused(case):
    check_case(*case)


@pytest.mark.parametrize("top", ["B6-step", "B6-pond"])
def test_fused_engine_runs_the_policies_on_a_land_model(top):
    """``Simulation(engine="fused")`` with lagged equilibrium freeze-thaw
    (the plain version on the CPU) == the eager engine at rtol 1e-12, the
    pond included; the stepper is the frozen exchange around the projection
    around SSPRK33, as the JAX kernel traces it."""
    jm = jax_model(top, "+B3-eq", True)
    model = model_from_reference(jm, device="cpu")
    kw = dict(Y_init=state_from_numpy(cold_state(jm), device="cpu"), dt=2.0, tspan=(0.0, 8.0), saveat=4.0)
    eager = Simulation(model, SSPRK33(), **kw)
    fused = Simulation(model, SSPRK33(), engine="fused", steps_per_call=2, **kw)
    assert isinstance(fused.stepper, FrozenExchangeStepper)
    assert isinstance(fused.stepper.inner, PhaseEquilibriumStepper) and isinstance(fused.stepper.inner.inner, SSPRK33)
    se, sf = eager.run(), fused.run()
    assert fused._fused(2).name == f"B2+{top}+B3-eq"
    for group in ("soil", "surface"):
        for k, v in se.us[group].items():
            np.testing.assert_allclose(sf.us[group][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-16)
    assert float(torch.max(torch.abs(se.us["soil"]["theta_i"][-1] - se.us["soil"]["theta_i"][0]))) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases(("B6-pond", "B6-step-pond")), ids=case_id)
def test_cuda_pond_land_policy_instances_match_plain(cuda_device, case):  # noqa: F811
    cuda_matches_plain(cuda_device, *case)
    if case[1] == "-no-ice":
        cuda_matches_plain(cuda_device, *case, icy=True)
