"""The fused run's kernel modes of this slice on the CPU, f64, through the
kernels' plain version:

- B1-dt, the run-time step size: a launch at ``dt_run`` equals a run built
  with that step size, bit for bit, in every mode of the kernel table (its
  tables, its argument struct and its plain launch), and differs from the
  factory step's;
- B4+B5 and B4+B5+B7(-time), the implicit steppers under a MOST top: the
  fused run equals the port's eager engine bit for bit (without rows, with
  step-indexed and time-indexed rows), and without rows matches the JAX
  package's steps at rtol 1e-9.

The kernels themselves run on the card: ``chip_smoke.py`` phase 13 holds
them to these plain runs.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch.convert import state_to_numpy, stepper_from_reference
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil
from landhydrology_tpu_torch.models.land import LandModel
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.runtime import make_forced_segment_run
from landhydrology_tpu_torch.runtime.forcing_driver import TimeForcedStepper
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config_torch as gct

F64 = torch.float64


def _clone(Y):
    return {g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}


def _dt_run_models():
    """``{mode: (model, state, stepper, rows, time grid)}`` at nz=8 x 4, each
    with a time-dependent input: callable Dirichlet values and per-column
    parameters (coupled), a profile T(z, t) (water-only), callable profiles
    (heat-only), a callable atmosphere field (MOST), a rain pulse (LandModel),
    forcing rows, per-column kinds with a callable value, per-column depths."""
    from landhydrology_tpu_torch import (
        BatchedBC, Column, Dirichlet, FreeDrainage, PrescribedAtmosForcing, PrescribedHydrologyModel,
        PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, SoilEnergyModel, SoilHydrologyModel,
        SoilModel, SoilParams, VariableDepthColumn, VerticalFlux, initialize_states, imex,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import PulsePrecipitation, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    nz, ncol = 8, 4
    hm = vanGenuchten(n=2.0, alpha=2.6, Ksat=torch.linspace(1e-6, 3e-6, ncol, dtype=F64), theta_r=0.05)
    bcs = SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.3 + 1e-4 * t),
                                           energy=Dirichlet(lambda t: 290.0 + 1e-3 * t)),
                       bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)))
    coupled = SoilModel(domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,)),
                        energy_model=SoilEnergyModel(), hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
                        boundary_conditions=bcs, soil_param_set=SoilParams(nu=0.4, S_s=1e-3), device="cpu")

    def ic(z, m):
        th = torch.full((nz, ncol), 0.25, dtype=F64)
        ti = torch.full((nz, ncol), 0.01, dtype=F64)
        rcs = volumetric_heat_capacity(th, ti, coupled.soil_param_set.rho_c_ds, ps)
        return {"vartheta_l": th, "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(ti, rcs, torch.full_like(th, 275.0), ps)}

    Y, _ = initialize_states(coupled, ic, 0.0)
    water = dataclasses.replace(
        coupled, energy_model=PrescribedTemperatureModel(T_profile=lambda z, t: 285.0 + 3.0 * z + 1e-3 * t),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.3 + 1e-4 * t)),
                                         bottom=SoilComponentBC(hydrology=FreeDrainage())))
    Yw = {"soil": {k: Y["soil"][k] for k in ("vartheta_l", "theta_i")}}
    heat = dataclasses.replace(
        coupled, hydrology_model=PrescribedHydrologyModel(vartheta_l_profile=lambda z, t: 0.2 + 0.0 * z + 1e-5 * t),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(energy=Dirichlet(lambda t: 290.0 + 1e-3 * t)),
                                         bottom=SoilComponentBC(energy=VerticalFlux(0.0))))
    Yh = {"soil": {"rho_e_int": Y["soil"]["rho_e_int"]}}
    most = dataclasses.replace(coupled, boundary_conditions=SoilColumnBC(
        top=PrescribedAtmosForcing(u_atm=lambda t: 2.0 + 1e-3 * t, theta_atm=296.0, z_atm=2.0,
                                   theta_scale=lambda t: 290.0 + 1e-3 * t, rho_a_sfc=1.2, q_atm=0.005),
        bottom=bcs.bottom))
    land = LandModel(soil=most, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=5e-6, t_start=0.0, t_stop=3.0), tau_pond=120.0))
    Yl = dict(Y, surface={"h_s": torch.full((ncol,), 1e-4, dtype=F64)})
    rows = {"u_atm": np.linspace(1.0, 3.0, 5), "q_atm": np.full((5, ncol), 0.006)}  # a table of 5 rows
    step_rows = {k: v[:3] for k, v in rows.items()}  # one per step
    kinds = dataclasses.replace(coupled, boundary_conditions=SoilColumnBC(
        top=bcs.top, bottom=SoilComponentBC(
            hydrology=BatchedBC(kind=torch.tensor([0, 1, 2, 0], dtype=torch.int32),
                                value=lambda t: torch.full((ncol,), 0.3, dtype=F64) + 1e-4 * t),
            energy=VerticalFlux(0.0))))
    deep = dataclasses.replace(coupled, domain=VariableDepthColumn(
        z_bottom=-np.array([0.8, 1.0, 1.5, 2.0]), nelements=nz, batch_shape=(ncol,)))

    def implicit(name, m, tridiag="thomas"):
        return getattr(imex, name)(model=m, grid=make_function_space(m.domain, F64, "cpu"), iters=2,
                                   tridiag=tridiag)

    ssp = SSPRK33()
    cases = {
        "B1": (coupled, Y, ssp), "B1-no-ice": (dataclasses.replace(coupled, assume_no_ice=True), Y, ssp),
        "B2": (dataclasses.replace(coupled, coefficient_update="step"), Y, ssp),
        "B3-rate": (dataclasses.replace(coupled, freeze_thaw=FreezeThaw(tau=60.0)), Y, ssp),
        "B2+B3-eq": (dataclasses.replace(coupled, coefficient_update="step", freeze_thaw=EquilibriumFreezeThaw()),
                     Y, ssp),
        "B1-water": (water, Yw, ssp), "B1-heat": (heat, Yh, ssp),
        "B4-trbdf2": (coupled, Y, implicit("TRBDF2Soil", coupled)),
        "B4-trbdf2-pcr": (coupled, Y, implicit("TRBDF2Soil", coupled, "pcr")),
        "B4-be-soil": (coupled, Y, implicit("BackwardEulerSoil", coupled)),
        "B4-be-richards-water": (water, Yw, implicit("BackwardEulerRichards", water)),
        "B4-trbdf2-heat": (heat, Yh, implicit("TRBDF2Soil", heat)),
        "B5": (most, Y, ssp), "B2+B5": (dataclasses.replace(most, coefficient_update="step"), Y, ssp),
        "B6": (land, Yl, ssp), "B6-step": (dataclasses.replace(land, surface_update="step"), Yl, ssp),
        "B6+B7": (land, Yl, ssp, {"precipitation": np.full((3, ncol), 2e-6), **step_rows}, None),
        "B5+B7-time": (most, Y, ssp, rows, (0.5, 0.7, 5)),
        "B1+kinds": (kinds, Y, ssp), "B1+B8": (deep, Y, ssp),
        "B4-trbdf2+B5": (most, Y, implicit("TRBDF2Soil", most)),
        "B4-be-soil+B5": (most, Y, implicit("BackwardEulerSoil", most)),
        "B4-be-richards+B5": (most, Y, implicit("BackwardEulerRichards", most)),
        "B4-trbdf2+B5+B7": (most, Y, implicit("TRBDF2Soil", most), step_rows, None),
        "B4-trbdf2+B5+B7-time": (most, Y, implicit("TRBDF2Soil", most), rows, (0.5, 0.7, 5)),
    }
    return {k: v if len(v) == 5 else (*v, None, None) for k, v in cases.items()}


DT_RUN_MODES = tuple(_dt_run_models())


def _struct_values(args):
    """The argument struct's fields that are not pointers."""
    out = {}
    for name, ctype in args._fields_:
        if "c_void_p" in repr(ctype):
            continue
        value = getattr(args, name)
        out[name] = tuple(value) if hasattr(value, "__len__") else value
    return out


def _same_tables(a, b):
    if a is None or b is None:
        return a is b
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and bool(torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tables(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("mode", DT_RUN_MODES)
def test_dt_run_equals_a_run_built_with_that_dt(mode):
    """B1-dt: ``run(Y, t0, dt_run=h)`` of a run built at dt builds the tables
    (time-dependent BC values, profiles, atmosphere fields, rain), the
    argument struct and the plain launch of a run built at ``h``, bit for
    bit; at the factory's dt all three differ."""
    model, Y, stepper, rows, grid = _dt_run_models()[mode]
    fields = tuple(rows or ())
    h, dt, t0, n = 0.7, 2.0, 0.5, 3
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n, forcing_fields=fields,
                                   forcing_time_grid=grid)
    built = ck.make_fused_column_run(model, stepper, dt=h, steps_per_call=n, forcing_fields=fields,
                                     forcing_time_grid=grid)
    assert run.name == built.name == mode
    soil = model.soil if isinstance(model, LandModel) else model
    state = [Y["soil"][k] for k in run.fields]
    ncol = state[0].shape[1]
    assert _same_tables(run.tables(ncol, "cpu", t0, h), built.tables(ncol, "cpu", t0))
    pond = Y["surface"]["h_s"] if isinstance(model, LandModel) else None
    frows = run._forcing_rows(rows, ncol, "cpu")
    a, _ = run.launch_args(state, pond, t0, "cpu", frows, dt=h)
    b, _ = built.launch_args(state, pond, t0, "cpu", built._forcing_rows(rows, ncol, "cpu"))
    assert _struct_values(a) == _struct_values(b)
    out = state_to_numpy(run({g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}, t0, forcing=rows,
                             dt_run=torch.tensor(h, dtype=soil.float_dtype)))
    ref = state_to_numpy(built({g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}, t0, forcing=rows))
    factory = state_to_numpy(run({g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}, t0,
                                 forcing=rows))
    for group, fields_ in ref.items():
        for k, v in fields_.items():
            np.testing.assert_array_equal(out[group][k], v, err_msg=f"{mode}/{group}/{k}")
    assert any(not np.array_equal(factory[g][k], v) for g, f in ref.items() for k, v in f.items())
    assert not _same_tables(run.tables(ncol, "cpu", t0), built.tables(ncol, "cpu", t0))


def test_dt_run_is_rounded_to_the_model_dtype():
    """``dt_run`` is cast to the model dtype as JAX's ``jnp.asarray(dt_run,
    dtype)`` casts it: a Python number or a tensor of another dtype."""
    model = gct.build_model_and_state(torch.float32, "cpu")[0]
    run = ck.make_fused_column_run(model, dt=1.0)
    assert run.step_size(0.1) == float(np.float32(0.1)) != 0.1
    assert run.step_size(torch.tensor(0.1, dtype=F64)) == float(np.float32(0.1))
    assert run.step_size() == 1.0
    # the differentiable run (B9) casts dt_run the same way: its launch at
    # dt_run = 0.1 is the plain run's, bit for bit
    Y = gct.build_model_and_state(torch.float32, "cpu")[1]
    b9 = ck.make_fused_column_run(model, dt=1.0, steps_per_call=2, differentiable=True)
    plain = ck.make_fused_column_run(model, dt=1.0, steps_per_call=2)
    got = b9(Y, 0.0, dt_run=torch.tensor(0.1, dtype=F64))["soil"]
    ref = plain({"soil": {k: v.clone() for k, v in Y["soil"].items()}}, 0.0, dt_run=0.1)["soil"]
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def _b4_b5_case(stepper_cls, rows, time_indexed):
    """The JAX forced tests' MOST column with a stepper, 4 steps of dt=300
    from t=0: rows none, one per step, or a table of 6 on a 450 s grid."""
    model, Y, Ya, table, _ = gct.build_forced_model_state_and_rows(F64, "cpu")
    st = stepper_cls(model=model, grid=make_function_space(model.domain, F64, "cpu"), iters=2)
    forcing = grid = None
    if rows:
        forcing = {k: v[:6] if time_indexed else v[:4] for k, v in table.items()}
        grid = (0.0, 450.0, 6) if time_indexed else None
    return model, Y, Ya, st, forcing, grid


@pytest.mark.parametrize("rows", ["none", "step", "time"])
@pytest.mark.parametrize("stepper", ["TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"])
def test_implicit_under_most_fused_equals_eager(stepper, rows):
    """B4+B5 (and +B7, +B7-time): the fused run's plain version is the
    eager engine's steps, bit for bit: ``Simulation``'s stepper without
    rows, ``make_forced_segment_run(engine="torch")`` with step rows,
    ``TimeForcedStepper`` with a time-indexed table."""
    cls = {"TRBDF2Soil": TRBDF2Soil, "BackwardEulerSoil": BackwardEulerSoil,
           "BackwardEulerRichards": BackwardEulerRichards}[stepper]
    model, Y, Ya, st, forcing, grid = _b4_b5_case(cls, rows != "none", rows == "time")
    run = ck.make_fused_column_run(model, st, dt=300.0, steps_per_call=4, forcing_fields=tuple(forcing or ()),
                                   forcing_time_grid=grid)
    name = {"TRBDF2Soil": "B4-trbdf2", "BackwardEulerSoil": "B4-be-soil",
            "BackwardEulerRichards": "B4-be-richards"}[stepper]
    assert run.name == name + "+B5" + {"none": "", "step": "+B7", "time": "+B7-time"}[rows]
    fused = state_to_numpy(run(_clone(Y), 0.0, forcing=forcing))["soil"]
    dt = torch.tensor(300.0, dtype=F64)
    if rows == "step":
        eager, _ = make_forced_segment_run(model, st, dt=300.0, field_names=tuple(forcing))(Y, Ya, 0.0, forcing)
    else:
        grid_ = make_function_space(model.domain, F64, "cpu")
        step = st if rows == "none" else TimeForcedStepper(
            inner=st, model=model, grid=grid_, tables=forcing, t_start=grid[0], dt_forcing=grid[1])
        rhs = model.make_rhs(grid_)
        eager, t = Y, torch.tensor(0.0, dtype=F64)
        for _ in range(4):
            eager = step.step(rhs, eager, Ya, t, dt)
            t = t + dt
    for k, v in state_to_numpy(eager)["soil"].items():
        np.testing.assert_array_equal(fused[k], v, err_msg=k)


@pytest.mark.parametrize("stepper", ["TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"])
def test_implicit_under_most_fused_matches_jax(stepper):
    """B4+B5 without rows against the JAX package's steps (jitted, XLA) on
    the forced golden's MOST column: 4 steps of dt=300, rtol 1e-9 (JAX's
    bar between its engines for TR-BDF2 under forcing)."""
    from landhydrology_tpu import imex as jimex
    from tests.data import golden_config as gc

    jm, jY, jYa, _, _ = gc.build_forced_model_state_and_rows(jnp.float64)
    jst = getattr(jimex, stepper)(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    rhs = jax_make_rhs(jm, jax_grid(jm.domain, jnp.float64))

    @jax.jit
    def go(Y):
        def body(carry, _):
            Yc, t = carry
            return (jst.step(rhs, Yc, jYa, t, jnp.float64(300.0)), t + 300.0), None

        (Yf, _), _ = jax.lax.scan(body, (Y, jnp.float64(0.0)), None, length=4)
        return Yf

    ref = go(jY)
    model, Y, _, _, _ = gct.build_forced_model_state_and_rows(F64, "cpu")
    st = stepper_from_reference(jst, model)
    out = state_to_numpy(ck.make_fused_column_run(model, st, dt=300.0, steps_per_call=4)(_clone(Y), 0.0))
    for k, v in ref["soil"].items():
        np.testing.assert_allclose(out["soil"][k], np.asarray(v), rtol=1e-9, atol=1e-12, err_msg=k)
