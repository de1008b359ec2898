"""The LandModel on a water-only soil (kernel mode B6 under a plain top with
``PrescribedTemperatureModel``: ``B6-pond-water``, ``B6-step-pond-water``,
``B2+B6-pond-water``, ``B2+B6-step-pond-water``, each also with
``-no-ice``; ``csrc/land_kernel.cu`` and ``csrc/land_policy_kernel.cu``)
through the kernel's plain version, against the JAX package's fused kernel
in interpret mode, with and without streamed rain rows (B7).

- The column: ``test_torch_land.py::_jax_land``'s LandModel under its plain
  top (the rain pulse of 6e-6 m/s, tau_pond 120 s), its soil water-only: T
  prescribed as 275 K + 3 K/m z (270-275 K), ``TemperatureDependentViscosity``
  in the hydraulic conductivity, a zero-flux bottom; the state 0.20-0.30
  wet by column without ice, a pond of 0-2e-4 m.  2 steps of dt = 2 s
  from t0 = 30 s, f64, rtol 1e-12 (atol 1e-16, the pond 1e-18);
  ``FULL_CASE`` on 256 columns in two tiles of 128, the others on
  ``CHECK_NCOL`` in one tile, JAX's kernel compiled once per case.
- Which T the exchange sees: a fused run's auxiliary state carries no T, so
  land.py's ``_diagnose_state_T`` gives 288 K on a soil without rho_e_int,
  in JAX's kernel as in the port, while the soil rhs reads the profile.  The
  column is ponded and its infiltration capacity-limited, so the potential
  infiltration, and with it K at 288 K through the viscosity factor,
  decides the result: ``test_exchange_is_capacity_limited_at_288_K`` holds
  that, and that the profile's T would give another rate.
- No-ice cases also run on the icy state (theta_i 0.05, vartheta_l = nu -
  0.02 in the lower half).

The kernel is held against this plain version on the card in
``chip_smoke.py`` phase 17a; the ``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedTemperatureModel as JPrescribedT
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu.models.soil.water import TemperatureDependentViscosity as JViscosity
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models import land
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_pallas_kernel import NCOL, NZ
from tests.test_torch_land import _jax_land
from tests.test_torch_land_policies_b5 import CHECK_NCOL, DT, STEPS, T0, cuda_device, tile_of  # noqa: F401

#: the tops (exchange per stage or frozen per step), lagged or not, no ice or not
CASES = [(top, lagged, no_ice) for top in ("B6-pond", "B6-step-pond") for lagged in (False, True)
         for no_ice in (False, True)]


def case_id(case):
    return mode_of(*case)


def mode_of(top, lagged, no_ice):
    """The kernel table's name of a case (``B2+B6-step-pond-water-no-ice``)."""
    return ("B2+" if lagged else "") + top + "-water" + ("-no-ice" if no_ice else "")


def t_profile(z, t):
    """The prescribed T: 275 K at the surface, 3 K colder per metre down."""
    return 275.0 + 3.0 * z + 0.0 * t


def jax_water_land(top, lagged, no_ice, viscosity=True, ncol=NCOL):
    """The JAX LandModel of a case on its water-only soil, ``ncol``
    columns."""
    jm = _jax_land(most=False, surface_update="step" if "-step" in top else "stage",
                   coefficient_update="step" if lagged else "stage")
    soil = jm.soil
    bcs = soil.boundary_conditions
    hydrology = soil.hydrology_model
    if viscosity:
        hydrology = dataclasses.replace(hydrology, viscosity_factor=JViscosity())
    soil = dataclasses.replace(
        soil, energy_model=JPrescribedT(T_profile=t_profile), hydrology_model=hydrology, assume_no_ice=no_ice,
        domain=dataclasses.replace(soil.domain, batch_shape=(ncol,)),
        boundary_conditions=JSoilColumnBC(top=JSoilComponentBC(hydrology=bcs.top.hydrology),
                                          bottom=JSoilComponentBC(hydrology=bcs.bottom.hydrology)))
    return dataclasses.replace(jm, soil=soil)


def water_state(jm, icy=False):
    """The start state as JAX arrays: water 0.20-0.30 by column, no ice
    (``icy``: 0.05 of ice and vartheta_l = nu - 0.02 in the lower half; ice
    at the top would saturate the potential infiltration's face), a pond of
    0-2e-4 m."""
    ncol = jm.soil.domain.batch_shape[0]
    col = np.linspace(0.0, 1.0, ncol)[None]
    theta = np.array(np.broadcast_to(0.20 + 0.1 * col, (NZ, ncol)))
    ice = np.zeros((NZ, ncol))
    if icy:
        ice[: NZ // 2] = 0.05
        theta[: NZ // 2] = float(jm.soil.soil_param_set.nu) - 0.02
    return {"soil": {"vartheta_l": jnp.asarray(theta), "theta_i": jnp.asarray(ice)},
            "surface": {"h_s": jnp.asarray(np.linspace(0.0, 2e-4, ncol))}}


def rain_rows(seed=31, ncol=NCOL):
    """Per-column rain rows, 0-1.2e-5 m/s, one per step."""
    return {"precipitation": 1.2e-5 * np.random.default_rng(seed).random((STEPS, ncol))}


#: the case (top, lagged, no ice, rows) that keeps test_pallas_kernel.py's 256 columns in two tiles of 128;
#: the others run on CHECK_NCOL columns in one tile
FULL_CASE = ("B6-pond", False, False, False)


@functools.lru_cache(maxsize=None)
def jax_kernel(top, lagged, no_ice, rows, ncol):
    """JAX's fused kernel of a case in interpret mode under ``jax.jit``:
    compiled once per process, also for the icy state."""
    jm = jax_water_land(top, lagged, no_ice, ncol=ncol)
    return jax.jit(jax_fused(jm, JSSPRK33(), dt=DT, steps_per_call=STEPS, tile_cols=tile_of(ncol), interpret=True,
                             forcing_fields=("precipitation",) if rows else ()))


def run_water_case(top, lagged, no_ice, rows=False, icy=False):
    """JAX's fused kernel (interpret mode) against the port's fused run (its
    plain version on the CPU) at rtol 1e-12; returns the JAX final state."""
    ncol = NCOL if (top, lagged, no_ice, rows) == FULL_CASE else CHECK_NCOL
    jm = jax_water_land(top, lagged, no_ice, ncol=ncol)
    Y = water_state(jm, icy)
    forcing = rain_rows(ncol=ncol) if rows else None
    fields = tuple(forcing or ())
    ref = jax_kernel(top, lagged, no_ice, rows, ncol)(Y, T0, forcing=forcing)
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS, forcing_fields=fields)
    assert run.name == mode_of(top, lagged, no_ice) + ("+B7" if rows else "")
    assert ck._entry(run.mode, torch.float64)[0] == ("land_policy_kernel" if no_ice else "land_kernel")
    Yt = state_from_numpy(Y, device="cpu")
    run(Yt, T0, forcing=None if forcing is None else {k: torch.as_tensor(v) for k, v in forcing.items()})
    got = state_to_numpy(Yt)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for group, fields_ in ref.items():
        for k, v in fields_.items():
            np.testing.assert_allclose(got[group][k], v, rtol=1e-12, atol=1e-18 if k == "h_s" else 1e-16,
                                       err_msg=f"{group}/{k}")
    return ref


@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("rows", [False, True], ids=["", "rain_rows"])
def test_water_only_land_model_matches_jax_fused(case, rows):
    run_water_case(*case, rows=rows)
    if case[2]:
        run_water_case(*case, rows=rows, icy=True)


def test_exchange_is_capacity_limited_at_288_K():
    """At the start state every column's supply (rain plus pond drainage)
    exceeds the potential infiltration at 288 K, so the infiltration is that
    capacity, which the viscosity factor makes depend on T: at the profile's
    top T (about 275 K) it would be more than 10% smaller."""
    jm = jax_water_land("B6-pond", False, False)
    model = model_from_reference(jm, device="cpu")
    Y = state_from_numpy(water_state(jm), device="cpu")
    grid = make_function_space(model.soil.domain, torch.float64, "cpu")
    t = torch.tensor(T0, dtype=torch.float64)
    ex = land._exchange_from_state(model, grid, Y, {"zc": grid.zc, "soil": {}}, t)
    supply = ex["P"] + Y["surface"]["h_s"] / model.surface.tau_pond
    assert bool((ex["infiltration"] < supply).all())
    top = {k: v[-1:] for k, v in Y["soil"].items()}
    at_288 = land.potential_infiltration(model.soil, grid, dict(top, T=torch.full((1, NCOL), 288.0,
                                                                                   dtype=torch.float64)), t)
    torch.testing.assert_close(ex["infiltration"], at_288.reshape(-1), rtol=1e-14, atol=0.0)
    T_top = t_profile(grid.zc[-1:], t).expand(1, NCOL)
    at_profile = land.potential_infiltration(model.soil, grid, dict(top, T=T_top), t).reshape(-1)
    assert bool((at_profile < 0.9 * ex["infiltration"]).all())


def test_water_only_mode_words_and_scratch():
    """The 8 instances: distinct names, the source by policy, 6 scratch
    fields without lagged coefficients and 10 with (K alone is read)."""
    names = set()
    for top, lagged, no_ice in CASES:
        model = model_from_reference(jax_water_land(top, lagged, no_ice), device="cpu")
        mode = ck.kernel_mode(model)
        assert mode & ck.MODE_WATER and mode & ck.MODE_LAND and not mode & ck.MODE_MOST
        name = ck.mode_name(mode)
        assert name == mode_of(top, lagged, no_ice) and name not in names
        names.add(name)
        assert ck.scratch_fields(mode) == (10 if lagged else 6)
    assert len(names) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
@pytest.mark.parametrize("rows", [False, True], ids=["", "rain_rows"])
def test_cuda_water_only_land_instances_match_plain(cuda_device, case, rows):  # noqa: F811
    """Each instance against its plain version on the card, f64 rtol 1e-12."""
    for icy in (False, True) if case[2] else (False,):
        jm = jax_water_land(*case)
        model = model_from_reference(jm, device=cuda_device)
        Y = state_from_numpy(water_state(jm, icy), device=cuda_device)
        forcing = {k: torch.as_tensor(v, device=cuda_device) for k, v in rain_rows().items()} if rows else None
        fields = tuple(forcing or ())
        plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), DT, STEPS, Y, T0, forcing=forcing))
        run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS, forcing_fields=fields)
        before = ck.LAUNCHES[run.name]
        run(Y, T0, forcing=forcing)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[run.name] == before + 1
        got = state_to_numpy(Y)
        for group, fields_ in plain.items():
            for k, v in fields_.items():
                np.testing.assert_allclose(got[group][k], v, rtol=1e-12, atol=1e-18 if k == "h_s" else 1e-16,
                                           err_msg=f"{group}/{k}")


def test_fused_engine_runs_the_water_only_land_model():
    """``Simulation(engine="fused")`` on the lagged water-only LandModel with
    its exchange frozen per step (the plain version on the CPU) == the eager
    engine at rtol 1e-12, the pond included, with an auxiliary state that
    carries no T, as a fused run's does not."""
    from landhydrology_tpu_torch import Simulation

    jm = jax_water_land("B6-step-pond", True, False)
    model = model_from_reference(jm, device="cpu")
    grid = make_function_space(model.soil.domain, torch.float64, "cpu")
    kw = dict(Y_init=state_from_numpy(water_state(jm), device="cpu"), Ya_init={"zc": grid.zc, "soil": {}},
              dt=2.0, tspan=(0.0, 8.0), saveat=4.0)
    eager = Simulation(model, SSPRK33(), **kw)
    fused = Simulation(model, SSPRK33(), engine="fused", steps_per_call=2, **kw)
    assert isinstance(fused.stepper, land.FrozenExchangeStepper)
    se, sf = eager.run(), fused.run()
    assert fused._fused(2).name == "B2+B6-step-pond-water"
    for group in ("soil", "surface"):
        for k, v in se.us[group].items():
            np.testing.assert_allclose(sf.us[group][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-18)
