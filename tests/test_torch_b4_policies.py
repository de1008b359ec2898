"""The implicit steppers with step policies on the coupled plain soil
(kernel modes B4 with B2, B3-rate, B3-eq and no ice, ``csrc/implicit_kernel.cu``)
through the kernel's plain version against the JAX package's fused kernel
in interpret mode.

- ``TRBDF2Soil``, ``BackwardEulerSoil`` and ``BackwardEulerRichards``
  (iters=2; Thomas, and PCR under TR-BDF2) with lagged coefficients alone,
  rate and equilibrium freeze-thaw each alone and with lagged coefficients
  (the freeze golden's column, nz=16 x 4, 3 steps of dt=300, which forms
  ice), and ``assume_no_ice`` (golden #1, nz=24 x 8, 2 steps of dt=120):
  the plain version of ``make_fused_column_run`` equals JAX's
  ``make_fused_column_run(..., interpret=True)`` at rtol 1e-12.  The rate
  scheme relaxes over tau = 600 s, where the top cell forms ice, and over
  the freeze golden's tau = 60 s, where a step of 300 s is five relaxation
  times: the sources overshoot and the top cell ends with negative ice, in
  JAX as in the port;
- the mode names and the scratch of the new instances, and the
  combinations that stay refused (ROADMAP B4).

The kernel itself is held against this plain version on the card, in
``chip_smoke.py`` phase 14b.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import BackwardEulerRichards as JBER
from landhydrology_tpu.imex import BackwardEulerSoil as JBES
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JRate
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, stepper_from_reference
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import TRBDF2Soil
from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct

F64 = torch.float64
POLICIES = {  # name suffix, model options
    "lagged": ("+B2", {"coefficient_update": "step"}),
    "rate": ("+B3-rate", {"freeze_thaw": JRate(tau=600.0)}),
    "eq": ("+B3-eq", {"freeze_thaw": JEq()}),
    "lagged_rate": ("+B2+B3-rate", {"coefficient_update": "step", "freeze_thaw": JRate(tau=600.0)}),
    "lagged_eq": ("+B2+B3-eq", {"coefficient_update": "step", "freeze_thaw": JEq()}),
    "rate_tau60": ("+B3-rate", {"freeze_thaw": JRate(tau=60.0)}),
    "lagged_rate_tau60": ("+B2+B3-rate", {"coefficient_update": "step", "freeze_thaw": JRate(tau=60.0)}),
    "no_ice": ("-no-ice", {"assume_no_ice": True}),
}
STEPPERS = {"trbdf2": JTRBDF2, "be-soil": JBES, "be-richards": JBER}


def _case(policy):
    """The JAX model, start state, dt and steps of a policy's case."""
    if policy == "no_ice":
        model, Y, _, _ = gc.build_model_and_state(jnp.float64)
        dt, n = 120.0, 2
    else:
        model, Y, _, _ = gc.build_freeze_model_and_state(jnp.float64)
        model = dataclasses.replace(model, freeze_thaw=None)
        dt, n = 300.0, 3
    return dataclasses.replace(model, **POLICIES[policy][1]), Y, dt, n


#: every policy at tau = 600 s under each stepper with Thomas solves; PCR, a
#: run-time flag of the same instances, under TR-BDF2 with two of them;
#: tau = 60 s under each stepper, with PCR, and lagged under BE-soil
TAU60 = ("rate_tau60", "lagged_rate_tau60")
CASES = ([(p, s, "thomas") for p in POLICIES if p not in TAU60 for s in STEPPERS]
         + [("rate", "trbdf2", "pcr"), ("lagged_eq", "trbdf2", "pcr")]
         + [("rate_tau60", s, "thomas") for s in STEPPERS]
         + [("rate_tau60", "trbdf2", "pcr"), ("lagged_rate_tau60", "be-soil", "thomas")])


@pytest.mark.parametrize("policy,stepper,tridiag", CASES)
def test_plain_version_matches_jax_fused(policy, stepper, tridiag):
    """The port's fused run (its plain version on the CPU) against JAX's
    fused kernel in interpret mode, rtol 1e-12 (atol 1e-16); the mode is
    the named B4 + policy instance."""
    jm, Y, dt, n = _case(policy)
    jst = STEPPERS[stepper](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2, tridiag=tridiag)
    ncol = jm.domain.batch_shape[0]
    ref = jax_fused(jm, jst, dt=dt, steps_per_call=n, tile_cols=ncol, interpret=True)(Y, 0.0)
    model = model_from_reference(jm, device="cpu")
    st = stepper_from_reference(jst, model, device="cpu")
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)
    name = f"B4-{stepper}" + ("-no-ice" if policy == "no_ice" else "") + ("-pcr" if tridiag == "pcr" else "")
    assert run.name == name + ("" if policy == "no_ice" else POLICIES[policy][0])
    Yt = state_from_numpy(Y, device="cpu")
    got = run(Yt, 0.0)
    for k, v in ref["soil"].items():
        r = np.asarray(v)
        np.testing.assert_allclose(got["soil"][k].numpy(), r, rtol=1e-12, atol=1e-16, err_msg=k)
    ice = np.asarray(ref["soil"]["theta_i"])
    if policy.endswith("tau60"):
        assert float(np.max(np.abs(ice))) > 1e-4  # the phase change acted (and overshot)
    elif policy != "no_ice" and policy != "lagged":
        assert float(np.max(ice)) > 1e-4  # ice formed


def test_policy_instances_scratch_and_refusals():
    """The lagged instances keep their coefficients after the solver's
    fields (4, or 5 with rate sources), lagged coefficients with no ice too;
    the plain soil's policies run in ``implicit_policy_kernel.cu``, those on
    the water-only branch in their own source."""
    model, _, _, _ = gct.build_freeze_model_and_state(F64, "cpu")
    grid = make_function_space(model.domain, F64, "cpu")

    def mode(**kw):
        m = dataclasses.replace(model, **kw)
        return ck.make_fused_column_run(m, TRBDF2Soil(model=m, grid=grid, tridiag="pcr")).mode

    assert ck.scratch_fields(mode(coefficient_update="step", freeze_thaw=None)) == 17 + 4
    assert ck.scratch_fields(mode(coefficient_update="step")) == 17 + 5
    assert ck.scratch_fields(mode()) == 17
    lagged_dry = dataclasses.replace(model, coefficient_update="step", assume_no_ice=True, freeze_thaw=None)
    run = ck.make_fused_column_run(lagged_dry, TRBDF2Soil(model=lagged_dry, grid=grid, tridiag="pcr"))
    assert run.name == "B4-trbdf2-no-ice-pcr+B2" and ck.scratch_fields(run.mode) == 17 + 4
    assert ck._entry(run.mode, F64) == ("implicit_policy_kernel", "implicit_policy_kernel_f64")
    from landhydrology_tpu_torch import NoBC, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC

    bcs = model.boundary_conditions
    water = dataclasses.replace(
        model, energy_model=PrescribedTemperatureModel(), freeze_thaw=None, coefficient_update="step",
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=bcs.top.hydrology),
                                         bottom=SoilComponentBC(hydrology=bcs.bottom.hydrology, energy=NoBC())))
    run = ck.make_fused_column_run(water, TRBDF2Soil(model=water, grid=grid))
    assert run.name == "B4-trbdf2-water+B2" and ck.scratch_fields(run.mode) == 11 + 4
    assert ck._entry(run.mode, F64) == ("implicit_branch_kernel", "implicit_branch_kernel_f64")
    assert isinstance(model.freeze_thaw, FreezeThaw)
