"""The step policies under a MOST top and a LandModel (kernel modes B5 and
B6 with freeze-thaw or ``assume_no_ice``, each alone or with lagged
coefficients; ``csrc/land_policy_kernel.cu``) through the kernel's plain
version, against the JAX package's fused kernel in interpret mode.

This file holds the cases' builders and the MOST soil column (B5); the B6
tops are in ``test_torch_land_policies_b6.py`` and
``test_torch_land_policies_pond.py`` (split so that xdist spreads the
interpret-mode runs, 1-5 s each here).

- The column: ``test_pallas_kernel.py``'s soil (nz=16) under a cold MOST
  atmosphere (273.15 K, within 5.2 K of every column), the LandModel of
  ``test_torch_land.py::_jax_land`` around it; the state 268-278 K and 0.20-
  0.30 wet by column with 0.02 of ice everywhere, so the cold columns freeze
  and the warm ones thaw; a pond of 0-2e-4 m.  2 steps of dt = 2 s from t0 =
  30 s, f64.  ``CHECK_NCOL`` columns in one tile (JAX's kernel in interpret
  mode costs its trace and compile, the port's plain version grows with the
  columns); the cases of ``FULL_CASES`` keep ``test_pallas_kernel.py``'s 256
  columns in two tiles of 128, so that a tile or stride fault still shows.
  JAX's kernel of a case is compiled once (``jax_kernel``), also where it
  runs on a second state.
- The bar: rtol 1e-12 (atol 1e-16, the pond 1e-18).  Under
  ``EquilibriumFreezeThaw`` the projection's bisection resolves T to
  adjacent floating-point numbers, and JAX's pow and exp round apart from
  torch's in the last place, so a cell whose residual changes sign within
  an ulp of T may land one ulp of T apart: at most ``EQ_CELLS`` cells may
  pass the strict bar, by at most two ulps of T times the freezing curve's
  steepest slope (``chip_smoke.py::_check_freeze``'s allowance).
- Freeze cases: theta_i must grow in some cells and shrink in others.
  No-ice cases also run on ``icy``, the state with theta_i 0.05 and
  vartheta_l = nu - 0.02 in the lower half, where the rhs's cap of theta_l
  at nu - theta_i matters (ROADMAP C).

The kernel itself is held against this plain version on the card in
``chip_smoke.py`` phase 16a; the ``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedAtmosForcing as JAtmos
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JRate
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_pallas_kernel import NCOL, NZ
from tests.test_torch_land import _jax_land

#: a cold atmosphere: theta_atm within 5.2 K of every column's 268-278 K
COLD_ATMOS = dict(u_atm=2.0, theta_atm=273.15, z_atm=2.0, theta_scale=273.15, rho_a_sfc=1.29, q_atm=0.003)
#: the policies: mode name suffix and the soil's options
POLICIES = {
    "+B3-rate": {"freeze_thaw": JRate(tau=60.0)},
    "+B3-eq": {"freeze_thaw": JEq()},
    "-no-ice": {"assume_no_ice": True},
}
#: the five tops: the MOST soil column, then the LandModel's four
TOPS = ("B5", "B6", "B6-step", "B6-pond", "B6-step-pond")
DT, STEPS, T0 = 2.0, 2, 30.0
#: the most cells an equilibrium case may hold within the ulp allowance alone
EQ_CELLS = 4
#: the columns of a check, one tile; the cases (top, policy, lagged) that keep the 256 columns of
#: test_pallas_kernel.py in two tiles
CHECK_NCOL = 64
FULL_CASES = frozenset({("B5", "+B3-rate", False), ("B6", "+B3-rate", False)})


def case_ncol(top, policy, lagged):
    """The columns of a case's check: ``NCOL`` for ``FULL_CASES``, else
    ``CHECK_NCOL``."""
    return NCOL if (top, policy, lagged) in FULL_CASES else CHECK_NCOL


def tile_of(ncol):
    """The JAX kernel's tile: the whole batch up to 128 columns, else 128."""
    return ncol if ncol <= 128 else 128


def soil_of(jm):
    """The soil column of a case's JAX model."""
    return jm.soil if hasattr(jm, "surface") else jm


def mode_of(top, policy, lagged):
    """The kernel table's name of a case: ``B2+`` when lagged, then the
    top, then the policy (``B2+B6-step+B3-eq``)."""
    return ("B2+" if lagged else "") + top + policy


def cases(tops):
    """``(top, policy, lagged)`` of every case on ``tops``."""
    return [(top, policy, lagged) for top in tops for policy in POLICIES for lagged in (False, True)]


def case_id(case):
    return mode_of(*case)


def jax_model(top, policy, lagged, ncol=NCOL):
    """The JAX model of a case on ``ncol`` columns: the B5 soil column, or a
    LandModel with a MOST top or (``-pond``) the soil's zero-flux top, its
    exchange per stage or (``-step``) frozen per step."""
    most = not top.endswith("-pond")
    jm = _jax_land(most=most, surface_update="step" if "-step" in top else "stage",
                   coefficient_update="step" if lagged else "stage")
    soil = jm.soil
    if most:
        soil = dataclasses.replace(soil, boundary_conditions=dataclasses.replace(
            soil.boundary_conditions, top=JAtmos(**COLD_ATMOS)))
    soil = dataclasses.replace(soil, domain=dataclasses.replace(soil.domain, batch_shape=(ncol,)), **POLICIES[policy])
    return soil if top == "B5" else dataclasses.replace(jm, soil=soil)


def cold_state(jm, icy=False):
    """The cold start state of a case as JAX arrays (and a pond for a
    LandModel); ``icy``: theta_i 0.05 and vartheta_l = nu - 0.02 in the
    lower half of the column."""
    land = hasattr(jm, "surface")
    soil = soil_of(jm)
    ncol = soil.domain.batch_shape[0]
    col = np.linspace(0.0, 1.0, ncol)[None]
    theta = np.array(np.broadcast_to(0.20 + 0.1 * col, (NZ, ncol)))
    ice = np.full((NZ, ncol), 0.02)
    if icy:
        ice[: NZ // 2] = 0.05
        theta[: NZ // 2] = float(soil.soil_param_set.nu) - 0.02
    T = np.broadcast_to(268.0 + 10.0 * col, (NZ, ncol))
    rho_c_s = volumetric_heat_capacity(theta, ice, soil.soil_param_set.rho_c_ds, jps)
    Y = {"soil": {"vartheta_l": jnp.asarray(theta), "theta_i": jnp.asarray(ice),
                  "rho_e_int": jnp.asarray(volumetric_internal_energy(ice, rho_c_s, T, jps))}}
    if land:
        Y["surface"] = {"h_s": jnp.asarray(np.linspace(0.0, 2e-4, ncol))}
    return Y


@functools.lru_cache(maxsize=None)
def jax_kernel(top, policy, lagged, ncol, fields=(), time_grid=None):
    """JAX's fused kernel of a case (its model on ``ncol`` columns, SSPRK33,
    ``STEPS`` steps of ``DT``, ``fields`` streamed on ``time_grid``) in
    interpret mode over ``tile_of(ncol)``, under ``jax.jit``: compiled once
    per process, also for a second start state."""
    jm = jax_model(top, policy, lagged, ncol)
    return jax.jit(jax_fused(jm, JSSPRK33(), dt=DT, steps_per_call=STEPS, tile_cols=tile_of(ncol), interpret=True,
                             forcing_fields=fields, forcing_time_grid=time_grid))


def ulp_allowance(soil):
    """Two ulps of T (f64, at T_0) times the steepest slope of the JAX
    freezing curve below T_0, in theta_i (and theta_l)."""
    from landhydrology_tpu.models.soil.freeze_thaw import equilibrium_unfrozen_liquid

    T = np.linspace(jps.T_0 - 30.0, jps.T_0 - 1e-6, 300001)
    theta = np.asarray(equilibrium_unfrozen_liquid(soil.hydrology_model.hydraulic_model, jnp.asarray(T),
                                                   soil.soil_param_set.nu, jps))
    slope = float(np.max(np.abs(np.diff(theta) / np.diff(T))))
    return 2 * float(np.spacing(jps.T_0)) * slope * jps.rho_cloud_liq / jps.rho_cloud_ice


def assert_matches(got, ref, jm):
    """``got`` against ``ref`` at rtol 1e-12 (atol 1e-16, the pond 1e-18);
    under EquilibriumFreezeThaw at most ``EQ_CELLS`` cells past that bar,
    each within ``ulp_allowance`` in the water contents and rho_l LH_f0
    times it in rho_e_int."""
    soil = soil_of(jm)
    extra = ulp_allowance(soil) if isinstance(soil.freeze_thaw, JEq) else 0.0
    loose = 0
    for group, fields in ref.items():
        for k, v in fields.items():
            r, a = np.asarray(v), np.asarray(got[group][k])
            atol = 1e-18 if k == "h_s" else 1e-16
            bar = 1e-12 * np.abs(r) + atol
            past = np.abs(a - r) > bar
            if past.any() and extra:
                allowance = extra * (jps.rho_cloud_liq * jps.LH_f0 if k == "rho_e_int" else 1.0)
                np.testing.assert_array_less(np.abs(a - r)[past], bar[past] + allowance, err_msg=f"{group}/{k}")
                loose = max(loose, int(past.sum()))
                continue
            np.testing.assert_allclose(a, r, rtol=1e-12, atol=atol, err_msg=f"{group}/{k}")
    assert loose <= EQ_CELLS, f"{loose} cells past the strict bar"


def run_case(top, policy, lagged, icy=False):
    """The JAX fused kernel (interpret mode) and the port's fused run (its
    plain version on the CPU) on a case; returns ``(JAX model, start state,
    JAX final state, port run)`` after holding the port to JAX
    (``assert_matches``) and checking the run's mode name."""
    ncol = case_ncol(top, policy, lagged)
    jm = jax_model(top, policy, lagged, ncol)
    Y = cold_state(jm, icy)
    ref = jax_kernel(top, policy, lagged, ncol)(Y, T0)
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS)
    assert run.name == mode_of(top, policy, lagged)
    assert ck._entry(run.mode, torch.float64) == ("land_policy_kernel", "land_policy_kernel_f64")
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, T0) is Yt and ck.LAUNCHES == before
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert_matches(state_to_numpy(Yt), ref, jm)
    return jm, Y, ref, run


def check_case(top, policy, lagged):
    """``run_case``, and in the freeze cases that ice formed in some cells
    and melted in others; a no-ice case also on the icy state."""
    _, Y, ref, _ = run_case(top, policy, lagged)
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    if policy == "-no-ice":
        assert not change.any()  # no phase change
        jm, Yi, _, _ = run_case(top, policy, lagged, icy=True)
        soil = {k: np.asarray(v) for k, v in Yi["soil"].items()}
        assert np.any(soil["vartheta_l"] > float(soil_of(jm).soil_param_set.nu) - soil["theta_i"])
    else:
        assert int((change > 1e-8).sum()) > 100 and int((change < -1e-8).sum()) > 100


@pytest.mark.parametrize("case", cases(("B5",)), ids=case_id)
def test_most_soil_column_matches_jax_fused(case):
    check_case(*case)


def test_mode_words_names_and_scratch():
    """The 30 new modes: distinct names (the ``mode_name`` rules), the land
    policy source, scratch for the lagged rate sources' rho_c_s."""
    names = set()
    for top, policy, lagged in cases(TOPS):
        model = model_from_reference(jax_model(top, policy, lagged), device="cpu")
        mode = ck.kernel_mode(model)
        name = ck.mode_name(mode)
        assert name == mode_of(top, policy, lagged) and name not in names
        names.add(name)
        assert ck._entry(mode, torch.float32)[0] == "land_policy_kernel"
        assert ck.scratch_fields(mode) == (6 if not lagged else 11 if policy == "+B3-rate" else 10)
    assert len(names) == 30
    plain = model_from_reference(_jax_land(), device="cpu")
    assert ck._entry(ck.kernel_mode(plain), torch.float64)[0] == "land_kernel"


#: the cases of ``_refused`` that queue B item 2's remainder ported (per-column kinds or geometry under the
#: implicit steppers with a MOST top): the name of the run their call now builds from
#: ``implicit_most_columns_kernel``
PORTED_SINCE = {
    "rows_most": "B4-trbdf2+B3-rate+B5+kinds+B7",
    "rows_land": "B4-be-soil+B3-rate+B5+B8+B7",
    "kinds": "B4-be-soil+B3-rate+B5+kinds",
    "kinds_water_land": "B4-be-richards-no-ice+B5+kinds",
    "geometry": "B4-trbdf2+B2+B5+B8",
    "geometry_implicit_most": "B4-trbdf2+B3-rate+B5+B8",
    "implicit_under_most": "B4-trbdf2+B5+B8",
}


def _refused(case):
    """``(message pattern, the call)`` of one refusal the policy slices
    kept: the call raises ``NotImplementedError`` matching the pattern, or
    for the cases of ``PORTED_SINCE`` (pattern ``None``) builds its run."""
    from landhydrology_tpu_torch import (
        BatchedBC, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, VerticalFlux,
    )
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import BackwardEulerSoil, TRBDF2Soil
    from landhydrology_tpu_torch.models.soil.water import TemperatureDependentViscosity

    soil = model_from_reference(jax_model("B5", "+B3-rate", False), device="cpu")
    land = model_from_reference(jax_model("B6", "-no-ice", False), device="cpu")
    grid = make_function_space(soil.domain, torch.float64, "cpu")
    geometry = (torch.full((NCOL,), 0.125, dtype=torch.float64), grid.zc.expand(NZ, NCOL).contiguous())
    pond = model_from_reference(jax_model("B6-pond", "-no-ice", False), device="cpu")
    water = dataclasses.replace(pond, soil=dataclasses.replace(
        pond.soil, energy_model=PrescribedTemperatureModel(), assume_no_ice=False))
    water_soil = water.soil
    bcs = soil.boundary_conditions
    kinds = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(top=bcs.top, bottom=SoilComponentBC(
        energy=bcs.bottom.energy, hydrology=BatchedBC(kind=torch.zeros(NCOL, dtype=torch.int64)))))
    if case == "rows_most":  # the implicit steppers under MOST with forcing rows and per-column kinds
        return None, lambda: ck.make_fused_column_run(
            kinds, TRBDF2Soil(model=kinds, grid=grid), forcing_fields=("theta_atm",))
    if case == "rows_land":  # per-column geometry in an implicit policy mode under MOST, with rows
        return None, lambda: ck.make_fused_column_run(
            soil, BackwardEulerSoil(model=soil, grid=grid), streamed_geometry=geometry, forcing_fields=("theta_atm",))
    if case == "kinds":  # per-column kinds under an implicit stepper with a policy, under MOST
        return None, lambda: ck.make_fused_column_run(
            kinds, BackwardEulerSoil(model=kinds, grid=grid))
    from landhydrology_tpu_torch import PrescribedHydrologyModel
    from landhydrology_tpu_torch.imex import BackwardEulerRichards

    heat = dataclasses.replace(soil, hydrology_model=PrescribedHydrologyModel(), freeze_thaw=None,
                               boundary_conditions=SoilColumnBC(top=SoilComponentBC(energy=VerticalFlux(0.0)),
                                                                bottom=SoilComponentBC(energy=bcs.bottom.energy)))
    if case == "kinds_water_land":  # per-column kinds under an implicit stepper with no ice, under MOST
        no_ice = dataclasses.replace(kinds, assume_no_ice=True, freeze_thaw=None)
        return None, lambda: ck.make_fused_column_run(
            no_ice, BackwardEulerRichards(model=no_ice, grid=grid))
    if case == "geometry":  # per-column geometry under TR-BDF2 with lagged coefficients, under MOST
        lagged = dataclasses.replace(soil, coefficient_update="step", freeze_thaw=None)
        return None, lambda: ck.make_fused_column_run(
            lagged, TRBDF2Soil(model=lagged, grid=grid), streamed_geometry=geometry)
    if case == "geometry_implicit_most":  # per-column geometry under an implicit stepper with a policy
        return None, lambda: ck.make_fused_column_run(
            soil, TRBDF2Soil(model=soil, grid=grid), streamed_geometry=geometry)
    if case == "explicit_stepper":  # TR-BDF2 on the heat-only branch with per-column geometry: not queued
        return r"in mode B4-trbdf2-heat .*ROADMAP B8, not queued\)", lambda: ck.make_fused_column_run(
            heat, TRBDF2Soil(model=heat, grid=grid), streamed_geometry=geometry)
    if case == "water_only_land":  # TR-BDF2 on the heat-only branch with per-column energy kinds: not queued
        heat_kinds = dataclasses.replace(heat, boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=BatchedBC(kind=torch.zeros(NCOL, dtype=torch.int64), value=0.0)),
            bottom=heat.boundary_conditions.bottom))
        return r"in mode B4-trbdf2-heat .*ROADMAP B1-batched, not queued\)", lambda: ck.make_fused_column_run(
            heat_kinds, TRBDF2Soil(model=heat_kinds, grid=grid))
    if case == "implicit_under_most":  # the MOST soil under TR-BDF2 without a policy, with per-column geometry
        bare = dataclasses.replace(soil, freeze_thaw=None)
        return None, lambda: ck.make_fused_column_run(
            bare, TRBDF2Soil(model=bare, grid=grid), streamed_geometry=geometry)
    if case == "implicit_heat_branch":  # the policies on the heat-only branch, which JAX's kernel cannot run
        from landhydrology_tpu_torch import PrescribedHydrologyModel

        branch = dataclasses.replace(soil, hydrology_model=PrescribedHydrologyModel(), freeze_thaw=None,
                                     assume_no_ice=True, boundary_conditions=SoilColumnBC(
                                         top=SoilComponentBC(energy=VerticalFlux(0.0)),
                                         bottom=SoilComponentBC(energy=bcs.bottom.energy)))
        return r"heat-only branch.*imex.py:231.*ROADMAP B4\)", lambda: ck.make_fused_column_run(
            branch, TRBDF2Soil(model=branch, grid=grid))
    if case == "implicit_water_viscosity":  # the water-only sweep would read T from the auxiliary state
        visc = dataclasses.replace(water_soil, hydrology_model=dataclasses.replace(
            water_soil.hydrology_model, viscosity_factor=TemperatureDependentViscosity()))
        return r"TemperatureDependentViscosity.*ROADMAP B4\)", lambda: ck.make_fused_column_run(
            visc, TRBDF2Soil(model=visc, grid=grid))
    assert case == "implicit_land"
    return r"reference kernel cannot run.*ROADMAP B4\)", lambda: ck.make_fused_column_run(
        land, TRBDF2Soil(model=land.soil, grid=grid))


@pytest.mark.parametrize("case", ["rows_most", "rows_land", "kinds", "kinds_water_land", "geometry",
                                  "geometry_implicit_most", "explicit_stepper", "implicit_under_most",
                                  "implicit_heat_branch", "implicit_water_viscosity", "implicit_land",
                                  "water_only_land"])
def test_refusal_names_its_roadmap_item(case):
    """What stays refused, each a ``NotImplementedError`` naming its ROADMAP
    item: per-column BC kinds or geometry under TR-BDF2 on the heat-only
    branch (not queued); the implicit steppers with the policies on the
    heat-only branch, the water-only sweep with
    ``TemperatureDependentViscosity``, and a LandModel, which the reference
    kernel cannot run either (B4).  The cases of ``PORTED_SINCE`` (per-column
    kinds or geometry under the implicit steppers with a MOST top, with a
    policy or without, with forcing rows or not: B1-batched, B8) are ported
    since queue B item 2's remainder: each builds its run from
    ``implicit_most_columns_kernel``.  (The cases ``explicit_stepper`` and
    ``water_only_land`` named refusals ported earlier; they hold neighbours
    that stay.)"""
    pattern, call = _refused(case)
    if case in PORTED_SINCE:
        run = call()
        assert run.name == PORTED_SINCE[case] and ck.takes_per_column(run.mode)
        assert ck._entry(run.mode, torch.float64)[0] == "implicit_most_columns_kernel"
        return
    with pytest.raises(NotImplementedError, match=pattern):
        call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def cuda_matches_plain(device, top, policy, lagged, icy=False):
    """A new instance against its plain version on the card, f64 at the
    bar of ``assert_matches`` (the plain version in place of JAX)."""
    jm = jax_model(top, policy, lagged)
    Y = state_from_numpy(cold_state(jm, icy), device=device)
    model = model_from_reference(jm, device=device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), DT, STEPS, Y, T0))
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS)
    before = ck.LAUNCHES[run.name]
    run(Y, T0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    assert_matches(state_to_numpy(Y), plain, jm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases(("B5",)), ids=case_id)
def test_cuda_most_soil_policy_instances_match_plain(cuda_device, case):
    cuda_matches_plain(cuda_device, *case)
    if case[1] == "-no-ice":
        cuda_matches_plain(cuda_device, *case, icy=True)
