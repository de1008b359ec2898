"""The water-only and heat-only branches under the explicit steppers of
``csrc/rk_kernel.cu``: ForwardEuler, SSPRK22 and SSPRK104 in every branch
mode, and all four explicit steppers (SSPRK33 too) with lagged coefficients
and ``assume_no_ice``, alone and together, through the kernel's plain
version on the CPU against the JAX package.

The columns are golden #1's (nz=24 x 8, 3 steps of dt=10 from t0 = 30 s)
with the temperature prescribed (``285 + 3 z + 1e-3 t``, the water-only
branch) or the moisture and some ice prescribed (``0.3 + 0.05 z + 1e-5 t``
and ``0.01 + 0.002 z``, the heat-only branch), so the profiles' rows at
every stage time enter the sweep.  The port's ``make_fused_column_run``
equals the JAX package's jitted XLA ``Simulation`` at rtol 1e-12 (atol
1e-16), and JAX's fused kernel in interpret mode in each branch-policy
mode.  The kernel is held against this plain version on the card in
``chip_smoke.py`` phase 15a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology_tpu import NoBC as JNoBC
from landhydrology_tpu import PrescribedHydrologyModel as JPrescribedHydrology
from landhydrology_tpu import PrescribedTemperatureModel as JPrescribedTemperature
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from tests.data import golden_config as gc
from tests.test_torch_rk_kernel import assert_same, jax_xla, port_fused

POLICIES = {"": {}, "B2": {"coefficient_update": "step"}, "no-ice": {"assume_no_ice": True},
            "B2-no-ice": {"coefficient_update": "step", "assume_no_ice": True}}


def mode_name(branch, policy):
    base = "B2" if policy.startswith("B2") else "B1"
    return f"{base}-{branch}" + ("-no-ice" if policy.endswith("no-ice") else "")


def branch_case(branch, policy):
    """``(JAX model, JAX state, dt, steps, t0)`` of a branch's column."""
    model, Y, _, _ = gc.build_model_and_state(jnp.float64)
    bcs = model.boundary_conditions
    if branch == "water":
        model = dataclasses.replace(
            model, energy_model=JPrescribedTemperature(T_profile=lambda z, t: 285.0 + 3.0 * z + 1e-3 * t),
            boundary_conditions=JSoilColumnBC(
                top=JSoilComponentBC(hydrology=bcs.top.hydrology),
                bottom=JSoilComponentBC(hydrology=bcs.bottom.hydrology, energy=JNoBC())))
        Y = {"soil": {k: Y["soil"][k] for k in ("vartheta_l", "theta_i")}}
    else:
        model = dataclasses.replace(
            model, hydrology_model=JPrescribedHydrology(
                vartheta_l_profile=lambda z, t: 0.3 + 0.05 * z + 1e-5 * t,
                theta_i_profile=lambda z, t: 0.01 + 0.002 * z + 0.0 * t),
            boundary_conditions=JSoilColumnBC(top=JSoilComponentBC(energy=bcs.top.energy),
                                              bottom=JSoilComponentBC(energy=bcs.bottom.energy)))
        Y = {"soil": {"rho_e_int": Y["soil"]["rho_e_int"]}}
    return dataclasses.replace(model, **POLICIES[policy]), Y, 10.0, 3, 30.0


CASES = ([(b, p, s) for b in ("water", "heat") for p in POLICIES for s in ("ForwardEuler", "SSPRK22", "SSPRK104")]
         + [(b, p, "SSPRK33") for b in ("water", "heat") for p in POLICIES if p])


@pytest.mark.parametrize("branch,policy,stepper", CASES)
def test_plain_version_matches_jax_xla(branch, policy, stepper):
    jm, Y, dt, n, t0 = branch_case(branch, policy)
    name, got = port_fused(jm, Y, stepper, dt, n, t0)
    assert name == mode_name(branch, policy) + ("" if stepper == "SSPRK33" else f"@{stepper}")
    assert_same(got, jax_xla(jm, Y, stepper, dt, n, t0), Y["soil"])


@pytest.mark.parametrize("branch,policy,stepper", [
    ("water", "B2", "SSPRK104"), ("water", "no-ice", "SSPRK22"), ("water", "B2-no-ice", "SSPRK33"),
    ("heat", "B2", "ForwardEuler"), ("heat", "no-ice", "SSPRK104"), ("heat", "B2-no-ice", "SSPRK22"),
])
def test_plain_version_matches_jax_fused_kernel(branch, policy, stepper):
    """Each branch-policy mode against the JAX fused kernel in interpret mode."""
    jm, Y, dt, n, t0 = branch_case(branch, policy)
    ncol = jm.domain.batch_shape[0]
    ref = jax_fused(jm, getattr(jts, stepper)(), dt=dt, steps_per_call=n, tile_cols=ncol, interpret=True)(Y, t0)
    _, got = port_fused(jm, Y, stepper, dt, n, t0)
    assert_same(got, {k: np.asarray(v) for k, v in ref["soil"].items()}, Y["soil"])
