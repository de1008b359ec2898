"""Per-column BC kinds and geometry in the land policy modes and under the
other explicit steppers (``MODE_COLUMNS`` instances of
``csrc/land_policy_columns_kernel.cu`` and ``csrc/land_columns_kernel.cu``)
through the kernel's plain version, against the JAX package's fused kernel
in interpret mode.

- The column: ``test_torch_land_policies_b5.py``'s cold soil (nz=16, 268-278
  K by column with 0.02 of ice under a cold MOST atmosphere, or the
  LandModel around it) on 32 columns, each with its own depth (0.8-1.2 of 2
  m, a ``VariableDepthColumn``) and BC kinds at the bottom (hydrology flux,
  Dirichlet or free drainage; energy flux or Dirichlet) and, under a plain
  top, on the top energy face; ``test_torch_land_water.py``'s water-only
  LandModel likewise (hydrology kinds only).  2 steps of 2 s from t0 = 30 s,
  one tile, f64 at rtol 1e-12 (atol 1e-16, the pond 1e-18; the equilibrium
  cases within ``assert_matches``' ulp allowance).
- The cases: the production setting with rate freeze-thaw and per-column
  step-indexed rows (``B2+B6-step+B3-rate+kinds+B8+B7``: ice must form and
  melt); the MOST soil with no ice on the icy state
  (``B5-no-ice+kinds+B8``, where the rhs's cap of theta_l at nu - theta_i
  acts); one land mode under each of ForwardEuler, SSPRK22 and SSPRK104.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from landhydrology_tpu import BatchedBC as JBatchedBC
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import SoilEnergyModel as JSoilEnergy
from landhydrology_tpu import VariableDepthColumn as JVariableDepth
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
from tests.test_torch_land_columns import jax_reference, run_port
from tests.test_torch_land_policies_b5 import assert_matches, jax_model, soil_of
from tests.test_torch_land_water import jax_water_land

#: the cases' columns, levels, steps of DT from T0
NCOL, NZ, DT, STEPS, T0 = 32, 16, 2.0, 2, 30.0


def jax_with_columns(jm, seed=5):
    """``jm`` (a JAX MOST soil or LandModel of the cold or water-only
    column) on ``NCOL`` columns, each with its own depth (0.8-1.2 of 2 m)
    and BC kinds: at the bottom the hydrology FLUX (-1e-7 m/s), DIRICHLET
    (0.30) or FREE_DRAINAGE, the energy (a dynamic one) FLUX (0) or
    DIRICHLET (268-278 K), and under a plain top its energy likewise."""
    soil = soil_of(jm)
    rng = np.random.default_rng(seed)

    def energy_kinds():
        kind = jnp.asarray(rng.integers(0, 2, NCOL), dtype=jnp.int32)
        return JBatchedBC(kind=kind, value=jnp.where(kind == 1, jnp.asarray(rng.uniform(268.0, 278.0, NCOL)), 0.0))

    coupled = isinstance(soil.energy_model, JSoilEnergy)
    kind = jnp.asarray(rng.integers(0, 3, NCOL), dtype=jnp.int32)
    water = JBatchedBC(kind=kind, value=jnp.where(kind == 1, 0.30, -1e-7))
    bcs = soil.boundary_conditions
    bottom = JSoilComponentBC(hydrology=water, energy=energy_kinds() if coupled else bcs.bottom.energy)
    top = bcs.top
    if isinstance(top, JSoilComponentBC) and coupled:
        top = dataclasses.replace(top, energy=energy_kinds())
    soil = dataclasses.replace(
        soil, boundary_conditions=JSoilColumnBC(top=top, bottom=bottom),
        domain=JVariableDepth(z_bottom=jnp.asarray(-2.0 * rng.uniform(0.8, 1.2, NCOL)), nelements=NZ,
                              batch_shape=(NCOL,)))
    return dataclasses.replace(jm, soil=soil) if hasattr(jm, "surface") else soil


def columns_state(jm, icy=False, water_only=False):
    """The cold start state of ``test_torch_land_policies_b5.cold_state`` on
    ``NCOL`` columns (268-278 K, water 0.20-0.30 by column, 0.02 of ice;
    ``icy``: 0.05 of ice and vartheta_l = nu - 0.02 in the lower half), or
    the water-only one (no ice, no energy); a pond of 0-2e-4 m on a
    LandModel."""
    soil = soil_of(jm)
    col = np.linspace(0.0, 1.0, NCOL)[None]
    theta = np.array(np.broadcast_to(0.20 + 0.1 * col, (NZ, NCOL)))
    ice = np.full((NZ, NCOL), 0.0 if water_only else 0.02)
    if icy:
        ice[: NZ // 2] = 0.05
        theta[: NZ // 2] = float(soil.soil_param_set.nu) - 0.02
    Y = {"soil": {"vartheta_l": jnp.asarray(theta), "theta_i": jnp.asarray(ice)}}
    if not water_only:
        T = np.broadcast_to(268.0 + 10.0 * col, (NZ, NCOL))
        rho_c_s = volumetric_heat_capacity(theta, ice, soil.soil_param_set.rho_c_ds, jps)
        Y["soil"]["rho_e_int"] = jnp.asarray(volumetric_internal_energy(ice, rho_c_s, T, jps))
    if soil is not jm:
        Y["surface"] = {"h_s": jnp.asarray(np.linspace(0.0, 2e-4, NCOL))}
    return Y


def check_case(jm, Y, stepper, name, source, forcing=None):
    """JAX's fused kernel (interpret mode, one tile) against the port's
    fused run under ``stepper`` (a name of both packages' ``timestepping``)
    at ``assert_matches``' bar; returns the JAX final state."""
    ref = jax_reference(jm, getattr(jts, stepper)(), DT, STEPS, Y, T0, forcing)
    got = run_port(jm, stepper, DT, STEPS, Y, T0, name, source, forcing)
    assert_matches(got, ref, jm)
    change = np.abs(ref["soil"]["vartheta_l"] - np.asarray(Y["soil"]["vartheta_l"]))
    assert float(change.max()) > 1e-6
    return ref


def test_production_rate_setting_with_kinds_geometry_and_rows():
    """``B2+B6-step+B3-rate+kinds+B8+B7``: the production LandModel under
    rate freeze-thaw, per-column kinds and depths, per-column theta_atm and
    rain rows; ice forms in the cold columns and melts in the warm ones."""
    jm = jax_with_columns(jax_model("B6-step", "+B3-rate", True))
    Y = columns_state(jm)
    rng = np.random.default_rng(23)
    rows = {"theta_atm": 273.15 + 8.0 * (2.0 * rng.random((STEPS, NCOL)) - 1.0),
            "precipitation": 1.2e-5 * rng.random((STEPS, NCOL))}
    ref = check_case(jm, Y, "SSPRK33", "B2+B6-step+B3-rate+kinds+B8+B7", "land_policy_columns_kernel", rows)
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    assert int((change > 1e-8).sum()) > 20 and int((change < -1e-8).sum()) > 20


def test_no_ice_cap_on_an_icy_state_with_kinds_and_geometry():
    """``B5-no-ice+kinds+B8`` on the icy state, where vartheta_l passes nu -
    theta_i and the rhs's cap acts; theta_i stays as it was."""
    jm = jax_with_columns(jax_model("B5", "-no-ice", False))
    Y = columns_state(jm, icy=True)
    soil = {k: np.asarray(v) for k, v in Y["soil"].items()}
    assert np.any(soil["vartheta_l"] > float(jm.soil_param_set.nu) - soil["theta_i"])
    ref = check_case(jm, Y, "SSPRK33", "B5-no-ice+kinds+B8", "land_policy_columns_kernel")
    np.testing.assert_array_equal(ref["soil"]["theta_i"], soil["theta_i"])


STEPPER_CASES = (("ForwardEuler", "B6", "B6+kinds+B8@ForwardEuler", "land_columns_kernel"),
                 ("SSPRK22", "B5+B3-eq", "B5+B3-eq+kinds+B8@SSPRK22", "land_policy_columns_kernel"),
                 ("SSPRK104", "B2+B6-step-pond-water-no-ice", "B2+B6-step-pond-water-no-ice+kinds+B8@SSPRK104",
                  "land_policy_columns_kernel"))


@pytest.mark.parametrize("stepper,case,name,source", STEPPER_CASES, ids=[c[2] for c in STEPPER_CASES])
def test_other_steppers_with_kinds_and_geometry(stepper, case, name, source):
    """One land mode under each of ForwardEuler (B6), SSPRK22 (B5 with the
    equilibrium projection) and SSPRK104 (the water-only production
    LandModel with no ice), each with kinds and depths."""
    if "-water" in case:
        jm = jax_with_columns(jax_water_land("B6-step-pond", True, True))
        Y = columns_state(jm, water_only=True)
    else:
        top, policy = (case.split("+", 1) + [""])[:2]
        jm = jax_with_columns(jax_model(top, "+" + policy if policy else "-no-ice", False))
        if not policy:  # B6 without a policy
            jm = dataclasses.replace(jm, soil=dataclasses.replace(jm.soil, assume_no_ice=False))
        Y = columns_state(jm)
    check_case(jm, Y, stepper, name, source)
