"""The PyTorch port's LandModel (``models/land.py``) and its fused run
against the JAX package.

- the land rhs, with and without a MOST top, with both routings, f64 rtol
  1e-13; one ``FrozenExchangeStepper`` step;
- the eager ``Simulation`` reproduces ``golden_land_f64.npz`` (routing
  included) at rtol 1e-13, and ``golden_config_torch`` rebuilds its
  configuration without JAX;
- the fused run (the kernel's plain version on the CPU) against the JAX
  package's fused kernel in interpret mode at rtol 1e-12: the MOST column of
  ``test_pallas_kernel.py:215`` (B5), the LandModel of ``:278`` (B6) and
  ``surface_update="step"`` with lagged coefficients (B2+B6-step);
- ``model_from_reference`` of a JAX LandModel, and the fused run's refusals.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedAtmosForcing as JAtmos
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import VerticalFlux as JVerticalFlux
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models import land as jland
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import Simulation
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.models import land
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct
from tests.test_pallas_kernel import NCOL, NZ, _model, _state

GOLDEN = "tests/data/golden_land_f64.npz"
FIELDS = ("vartheta_l", "theta_i", "rho_e_int")
ATMOS = dict(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005)


def _assert_states_close(got, ref, rtol, atol=1e-18):
    for group, fields in ref.items():
        for k, v in fields.items():
            np.testing.assert_allclose(np.asarray(got[group][k]), np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{group}/{k}")


def _jax_land(most=True, runoff=None, surface_update="stage", coefficient_update="stage"):
    """The LandModel of ``test_pallas_kernel.py:278`` (rain + pond + MOST +
    energy), or with the soil's zero-flux top (``most=False``)."""
    base = _model(JVerticalFlux(0.0), JVerticalFlux(0.0))
    bottom = JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0))
    top = JAtmos(**ATMOS) if most else base.boundary_conditions.top
    soil = dataclasses.replace(base, boundary_conditions=JSoilColumnBC(top=top, bottom=bottom),
                               coefficient_update=coefficient_update)
    if runoff is not None:
        soil = dataclasses.replace(soil, domain=dataclasses.replace(soil.domain, batch_shape=(16, 16)))
    surface = jland.SurfaceWaterModel(
        precipitation=jland.PulsePrecipitation(rate=6e-6, t_start=0.0, t_stop=40.0),
        tau_pond=120.0, h_evap_smoothing=1e-4, runoff=runoff,
    )
    return jland.LandModel(soil=soil, surface=surface, surface_update=surface_update)


def _jax_land_state(jm, h_s0=0.0):
    batch = jm.soil.domain.batch_shape

    def ic(z, m):
        shape = (NZ, *batch)
        col = jnp.linspace(0.0, 1.0, int(np.prod(batch))).reshape(batch)[None]
        th = jnp.broadcast_to(0.18 + 0.05 * col, shape)
        ti = jnp.zeros(shape)
        T = jnp.broadcast_to(290.0 + 2.0 * col + 0.0 * z.reshape((NZ,) + (1,) * len(batch)), shape)
        rcs = volumetric_heat_capacity(th, ti, m.soil_param_set.rho_c_ds, jps)
        return {"vartheta_l": th, "theta_i": ti, "rho_e_int": volumetric_internal_energy(ti, rcs, T, jps)}

    return jland.initialize_states(jm, ic, 0.0, h_s0=h_s0)


def _port(jm, Y):
    return model_from_reference(jm, device="cpu"), state_from_numpy(Y, device="cpu")


@pytest.mark.parametrize(
    "case", ["most", "pond", "most_kinematic", "pond_diffusive"],
)
def test_land_rhs_matches_jax(case):
    """The land tendency (exchange + soil + pond, and routing on a 2-D grid)
    == JAX's at a ponded state, f64 rtol 1e-13 (atol 1e-13 of each field's
    scale)."""
    runoff = {"most_kinematic": jland.KinematicWaveRouting(
                  elevation=jnp.asarray(0.1 * np.random.default_rng(1).random((16, 16))), manning_n=0.05),
              "pond_diffusive": jland.RunoffRouting(conductance=1e-2, h_detention=1e-4)}.get(case)
    jm = _jax_land(most=case.startswith("most"), runoff=runoff)
    h_s0 = jnp.asarray(np.random.default_rng(2).uniform(0.0, 3e-4, jm.soil.domain.batch_shape))
    Y, Ya = _jax_land_state(jm, h_s0)
    ref = jland.make_rhs(jm)(Y, Ya, jnp.asarray(12.0))
    model, Yt = _port(jm, Y)
    got = land.make_rhs(model)(Yt, state_from_numpy(Ya, device="cpu"), torch.tensor(12.0, dtype=torch.float64))
    for group, fields in ref.items():
        for k, v in fields.items():
            r = np.asarray(v)
            scale = float(np.max(np.abs(r))) or 1.0
            np.testing.assert_allclose(got[group][k].numpy(), r, rtol=1e-13, atol=1e-13 * scale,
                                       err_msg=f"{group}/{k}")
    assert float(np.max(np.abs(np.asarray(ref["surface"]["h_s"])))) > 0.0


@pytest.mark.parametrize("coefficient_update", ["stage", "step"])
def test_frozen_exchange_step_matches_jax(coefficient_update):
    """One ``FrozenExchangeStepper`` step (surface_update="step", with stage
    or lagged coefficients) == JAX's, rtol 1e-13."""
    jm = _jax_land(surface_update="step", coefficient_update=coefficient_update)
    Y, Ya = _jax_land_state(jm, 5e-5)
    jst = jland.wrap_stepper_for_land(JSSPRK33(), jm)
    ref = jst.step(jland.make_rhs(jm), Y, Ya, jnp.asarray(4.0), jnp.asarray(2.0))
    model, Yt = _port(jm, Y)
    st = land.wrap_stepper_for_land(SSPRK33(), model)
    assert isinstance(st, land.FrozenExchangeStepper) and st.stages == 3
    f64 = torch.float64
    got = st.step(land.make_rhs(model), Yt, state_from_numpy(Ya, device="cpu"), torch.tensor(4.0, dtype=f64),
                  torch.tensor(2.0, dtype=f64))
    _assert_states_close(got, ref, rtol=1e-13)
    assert land.wrap_stepper_for_land(st, model) is st  # idempotent


def test_eager_simulation_reproduces_land_golden():
    """``golden_config_torch.build_land_model_and_state`` through the eager
    engine: 48 SSPRK33 steps with MOST, rain, the pond and kinematic-wave
    routing on a 4 x 4 grid, rtol 1e-13 against ``golden_land_f64.npz``."""
    golden = np.load(GOLDEN)
    model, Y, Ya, dt = gct.build_land_model_and_state(torch.float64, "cpu")
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, gct.LAND_STEPS * dt))
    sim.run()
    final = state_to_numpy(sim.Y)
    assert float(np.max(final["surface"]["h_s"])) > 1e-4
    for k in FIELDS:
        np.testing.assert_allclose(final["soil"][k], golden[k], rtol=1e-13, atol=1e-18, err_msg=k)
    np.testing.assert_allclose(final["surface"]["h_s"], golden["surface__h_s"], rtol=1e-13, atol=1e-20)


def test_golden_config_torch_builds_the_jax_land_configuration():
    jm, Y, Ya, dt = gc.build_land_model_and_state(jnp.float64)
    model, Yt, Yat, dtt = gct.build_land_model_and_state(torch.float64, "cpu")
    assert dt == dtt and gct.LAND_STEPS == gc.LAND_STEPS
    _assert_states_close(state_to_numpy(Yt), Y, rtol=0, atol=0)
    ref = model_from_reference(jm, device="cpu")
    assert ref.surface.precipitation == model.surface.precipitation
    assert torch.equal(ref.surface.runoff.elevation, model.surface.runoff.elevation)
    assert ref.soil.boundary_conditions.top == model.soil.boundary_conditions.top


def test_model_from_reference_carries_a_land_model():
    jm = _jax_land(runoff=jland.KinematicWaveRouting(elevation=jnp.zeros((16, 16))), surface_update="step")
    m = model_from_reference(jm, device="cpu", dtype=torch.float32)
    assert isinstance(m, land.LandModel) and m.surface_update == "step"
    assert isinstance(m.surface.precipitation, land.PulsePrecipitation)
    assert m.surface.precipitation.rate == 6e-6 and m.surface.tau_pond == 120.0
    assert isinstance(m.surface.runoff, land.KinematicWaveRouting)
    assert m.surface.runoff.elevation.dtype == torch.float32 and m.surface.runoff.elevation.shape == (16, 16)
    assert m.soil.dtype == torch.float32 and m.soil.boundary_conditions.top.u_atm == 2.0
    assert m.float_dtype == torch.float32 and m.domain is m.soil.domain


@pytest.mark.parametrize("case", ["B5", "B6", "B2+B6-step"])
def test_plain_fused_run_matches_jax_fused_kernel(case):
    """The port's fused run (the plain version on the CPU) == the JAX
    package's fused kernel in interpret mode, 2 steps from t0 = 30, rtol
    1e-12: the MOST column of ``test_pallas_kernel.py:215`` (B5), the
    LandModel of ``:278`` (B6; the pond forms) and ``surface_update="step"``
    with lagged coefficients."""
    if case == "B5":
        base = _model(JVerticalFlux(0.0), JVerticalFlux(0.0))
        jm = dataclasses.replace(base, boundary_conditions=dataclasses.replace(
            base.boundary_conditions, top=JAtmos(u_atm=0.34, theta_atm=299.0, z_atm=0.05, theta_scale=299.0,
                                                 rho_a_sfc=1.17, q_atm=0.015)))
        Y, dt = _state(), 20.0
    else:
        jm = _jax_land(surface_update="step" if case != "B6" else "stage",
                       coefficient_update="step" if case != "B6" else "stage")
        Y, dt = _jax_land_state(jm, 2e-5)[0], 2.0
    ref = jax_fused(jm, JSSPRK33(), dt=dt, steps_per_call=2, tile_cols=128, interpret=True)(Y, 30.0)
    model, Yt = _port(jm, Y)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=2)
    assert ck.mode_name(run.mode) == case
    before = dict(ck.LAUNCHES)
    assert run(Yt, 30.0) is Yt and ck.LAUNCHES == before
    _assert_states_close(state_to_numpy(Yt), jax.tree_util.tree_map(np.asarray, ref), rtol=1e-12)
    if case != "B5":
        assert float(np.max(np.asarray(ref["surface"]["h_s"]))) > 2e-5  # the pond grows


def test_fused_engine_runs_the_land_model():
    """``Simulation(engine="fused")`` on a LandModel (the plain version on
    the CPU) == the eager engine, saved states at rtol 1e-12, the pond
    included; the stepper is wrapped in the frozen exchange."""
    jm = _jax_land(surface_update="step")
    Y, Ya = _jax_land_state(jm, 1e-5)
    model, Yt = _port(jm, Y)
    kw = dict(Y_init=Yt, Ya_init=state_from_numpy(Ya, device="cpu"), dt=2.0, tspan=(0.0, 10.0), saveat=4.0)
    eager = Simulation(model, SSPRK33(), **kw)
    fused = Simulation(model, SSPRK33(), engine="fused", steps_per_call=2, **kw)
    assert isinstance(fused.stepper, land.FrozenExchangeStepper)
    se, sf = eager.run(), fused.run()
    assert sorted(fused._fused_runs) == [1, 2]
    for group in ("soil", "surface"):
        for k, v in se.us[group].items():
            np.testing.assert_allclose(sf.us[group][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-18)


def test_fused_run_refusals():
    """What the JAX kernel's factory refuses (routing, per-column rain, a
    2-D batch: ValueError) and what the kernel does not run (NotImplementedError
    naming ROADMAP B4): the implicit steppers with a LandModel.  Freeze-thaw
    and no ice run under MOST and a LandModel, with forcing rows too."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
    from landhydrology_tpu_torch.imex import TRBDF2Soil

    model = model_from_reference(_jax_land(), device="cpu")
    with pytest.raises(ValueError, match="routing"):
        ck.make_fused_column_run(dataclasses.replace(
            model, surface=dataclasses.replace(model.surface, runoff=land.RunoffRouting())))
    per_column = dataclasses.replace(model, surface=dataclasses.replace(
        model.surface, precipitation=lambda t: torch.full((NCOL,), 1e-6, dtype=torch.float64)))
    with pytest.raises(ValueError, match="per-column precipitation"):
        ck.make_fused_column_run(per_column)
    with pytest.raises(ValueError, match="per-column precipitation"):
        ck.precipitation_table(per_column.surface.precipitation, [torch.tensor(0.0)], torch.float64, "cpu")
    soil2d = dataclasses.replace(model.soil, domain=dataclasses.replace(model.soil.domain, batch_shape=(16, 16)))
    with pytest.raises(ValueError, match="1-D column batch"):
        ck.make_fused_column_run(dataclasses.replace(model, soil=soil2d))
    # freeze-thaw and no ice run under MOST and a LandModel, with streamed forcing rows too
    Y, _ = _jax_land_state(_jax_land(), 1e-5)
    for kw, suffix in (({"freeze_thaw": FreezeThaw(tau=60.0)}, "+B3-rate"), ({"assume_no_ice": True}, "-no-ice")):
        soil = dataclasses.replace(model.soil, **kw)
        assert ck.make_fused_column_run(dataclasses.replace(model, soil=soil)).name == "B6" + suffix
        assert ck.make_fused_column_run(soil).name == "B5" + suffix
        for m, field, name in ((dataclasses.replace(model, soil=soil), "precipitation", "B6"), (soil, "u_atm", "B5")):
            run = ck.make_fused_column_run(m, dt=2.0, steps_per_call=2, forcing_fields=(field,))
            assert run.name == name + suffix + "+B7"
            Yt = state_from_numpy(Y if name == "B6" else {"soil": Y["soil"]}, device="cpu")
            rows = torch.full((2, NCOL), 1e-6 if field == "precipitation" else 3.0, dtype=torch.float64)
            run(Yt, 0.0, forcing={field: rows})
            assert all(bool(torch.isfinite(v).all()) for f in Yt.values() for v in f.values())
    from landhydrology_tpu_torch.domains import make_function_space

    # the implicit steppers run under the soil's MOST top (B4+B5), not with the LandModel, which the
    # reference kernel cannot run either (ROADMAP B4)
    st = TRBDF2Soil(model=model.soil, grid=make_function_space(model.soil.domain, torch.float64, "cpu"))
    assert ck.make_fused_column_run(model.soil, st).name == "B4-trbdf2+B5"
    with pytest.raises(NotImplementedError, match="ROADMAP B4"):
        ck.make_fused_column_run(model, st)
    with pytest.raises(ValueError, match="negative"):
        land.PulsePrecipitation(rate=-1e-6)
    with pytest.raises(ValueError, match="negative"):
        land.ConstantPrecipitation(rate=torch.tensor([1e-6, -1e-6]))
    negative = dataclasses.replace(model, surface=dataclasses.replace(model.surface, precipitation=lambda t: -1e-6))
    with pytest.raises(ValueError, match="non-negative"):
        ck.precipitation_table(negative.surface.precipitation, [torch.tensor(0.0)], torch.float64, "cpu")


def test_land_mode_names_and_tables():
    """Every B5/B6 mode word and name; the precipitation table of the
    declarative pulse is one vectorised call equal to the per-time calls;
    the top face's exchanged slots get BC_FLUX and a zero table."""
    model = model_from_reference(_jax_land(), device="cpu")
    pond = model_from_reference(_jax_land(most=False), device="cpu")
    names = {}
    for m in (model, pond):
        for su in ("stage", "step"):
            for cu in ("stage", "step"):
                lm = dataclasses.replace(m, surface_update=su, soil=dataclasses.replace(m.soil, coefficient_update=cu))
                run = ck.make_fused_column_run(lm)
                names[ck.mode_name(run.mode)] = run.mode
                assert ck._entry(run.mode, torch.float64) == ("land_kernel", "land_kernel_f64")
                assert ck.scratch_fields(run.mode) == (10 if cu == "step" else 6)
        names[ck.mode_name(ck.kernel_mode(m.soil))] = ck.kernel_mode(m.soil)
    assert sorted(names) == sorted(["B6", "B6-step", "B2+B6", "B2+B6-step", "B6-pond", "B6-step-pond",
                                    "B2+B6-pond", "B2+B6-step-pond", "B5", "B1"])
    assert names["B2+B6-step"] == ck.MODE_LAND | ck.MODE_MOST | ck.MODE_LAGGED | ck.MODE_SURFACE_STEP
    times, _ = ck.table_times(SSPRK33(), 35.0, 2.0, 4, torch.float64)
    pulse = model.surface.precipitation
    table = ck.precipitation_table(pulse, times, torch.float64, "cpu")
    assert torch.equal(table, torch.stack([torch.as_tensor(pulse(t), dtype=torch.float64) for t in times]))
    assert table[0] == 6e-6 and table[-1] == 0.0  # the pulse stops at t = 40
    tables = ck.bc_tables(model, 0.0, 2.0, 4, NCOL, "cpu")
    assert [t is None for t in tables] == [False, False, False, False]
    assert ck.exchanged_components(model) == ("energy", "hydrology")
    assert ck.exchanged_components(pond) == ("hydrology",)
    surface = ck.surface_tables(model, 0.0, 2.0, 4, NCOL, "cpu")
    assert [t is not None for t in surface] == [True] * len(ck.SURFACE_NAMES)
    assert [t is not None for t in ck.surface_tables(pond, 0.0, 2.0, 4, NCOL, "cpu")] == [False] * 8 + [True] * 2


def test_kernel_args_of_a_land_model():
    model = model_from_reference(_jax_land(most=True, surface_update="step"), device="cpu")
    Y, _ = _jax_land_state(_jax_land(), 1e-5)
    Yt = state_from_numpy(Y, device="cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=2.0, steps_per_call=3)
    params, zc, dz, bc, surface, profiles = run._inputs(NCOL, torch.device("cpu"))
    assert run._inputs(NCOL, torch.device("cpu"))[4] is surface
    times, _ = ck.table_times(run.stepper, 0.0, 2.0, 3, torch.float64)
    precip = ck.precipitation_table(model.surface.precipitation, times, torch.float64, "cpu")
    fields = [Yt["soil"][k] for k in FIELDS]
    scratch = torch.empty(6 * NZ * NCOL, dtype=torch.float64)
    a = ck.kernel_args(model, fields, scratch, zc, dz, params, bc, 3, 2.0, surface=surface, precip=precip,
                       h_s=Yt["surface"]["h_s"])
    assert a.mode == ck.MODE_LAND | ck.MODE_MOST | ck.MODE_SURFACE_STEP
    assert list(a.bc_kind) == [1, 1, 1, 1]  # the bottom's fluxes; the top's from the exchange
    assert a.h_s == Yt["surface"]["h_s"].data_ptr() and a.precip == precip.data_ptr()
    assert (a.von_karman_const, a.cp_l, a.molmass_ratio) == (0.4, 4181.0, 28.97e-3 / 18.01528e-3)
    assert list(a.surface_row_stride) == [0] * 10 and list(a.surface_col_stride) == [0] * 10
