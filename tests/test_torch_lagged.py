"""Lagged coefficients (``SoilModel(coefficient_update="step")``, kernel B2)
and ``assume_no_ice`` in the PyTorch port.

The same inputs go through the JAX package and the port in float64:

- ``rhs_with_coeffs(compute_coeffs(Y))`` of the port against the JAX
  package's, rtol 1e-13 of each field's largest tendency, and against the
  port's own stage rhs at the bar of
  ``tests/soil/test_lagged_coefficients.py`` (rtol 1e-12: the two differ by
  the reciprocal-multiply temperature diagnosis);
- the eager lagged run of golden #1 against ``golden_lagged_f64.npz``,
  rtol 1e-13, which is not the stage golden;
- the fused run (its plain version on the CPU) against the JAX Pallas
  kernel in interpret mode, rtol 1e-12.

Tests marked ``cuda`` launch the CUDA kernel and skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import Dirichlet as JDirichlet
from landhydrology_tpu import FreeDrainage as JFreeDrainage
from landhydrology_tpu import PrescribedHydrologyModel as JPrescribedHydrologyModel
from landhydrology_tpu import PrescribedTemperatureModel as JPrescribedTemperatureModel
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import VerticalFlux as JVerticalFlux
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.models.soil.lagged import make_coefficient_fns as jax_coefficient_fns
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    Simulation,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
)
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.diagnostics import energy_total, water_mass
from landhydrology_tpu_torch.models.soil.lagged import (
    LaggedCoefficientStepper,
    make_coefficient_fns,
    wrap_stepper_for_soil,
)
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33, ForwardEuler
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct
from tests.test_pallas_kernel import _model, _state

GOLDEN_LAGGED = "tests/data/golden_lagged_f64.npz"
GOLDEN_STAGE = "tests/data/golden_coupled_f64.npz"
FIELDS = ("vartheta_l", "theta_i", "rho_e_int")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _variant(name):
    """A JAX model (lagged) and state for each branch the coefficient
    functions cover."""
    base = _model(JDirichlet(lambda t: 0.4), JFreeDrainage())
    Y = _state()
    if name == "richards":
        base = dataclasses.replace(
            base, energy_model=JPrescribedTemperatureModel(),
            boundary_conditions=JSoilColumnBC(
                top=JSoilComponentBC(hydrology=JDirichlet(lambda t: 0.4)),
                bottom=JSoilComponentBC(hydrology=JFreeDrainage()),
            ),
        )
    elif name == "heat":
        base = dataclasses.replace(
            base,
            hydrology_model=JPrescribedHydrologyModel(
                vartheta_l_profile=lambda z, t: 0.2 + 0.0 * z,
                theta_i_profile=lambda z, t: 0.0 * z,
            ),
            boundary_conditions=JSoilColumnBC(
                top=JSoilComponentBC(energy=JDirichlet(lambda t: 288.0)),
                bottom=JSoilComponentBC(energy=JVerticalFlux(0.0)),
            ),
        )
        Y = {"soil": {"rho_e_int": Y["soil"]["rho_e_int"]}}
    elif name == "no_ice":
        base = dataclasses.replace(base, assume_no_ice=True)
    elif name == "icy":
        rng = np.random.default_rng(5)
        Y["soil"]["theta_i"] = jnp.asarray(0.04 * rng.random(Y["soil"]["theta_i"].shape))
    return dataclasses.replace(base, coefficient_update="step"), Y


def _aux(jm):
    grid = jax_grid(jm.domain, jnp.float64)
    return {"zc": grid.zc, "soil": {}}


def _port_aux(jm, t):
    """The port's aux state: zc, and the prescribed profiles at t."""
    from landhydrology_tpu_torch.models.soil.rhs import make_update_aux

    pm = model_from_reference(jm, device="cpu")
    Ya = {"zc": torch.as_tensor(np.array(_aux(jm)["zc"])), "soil": {}}
    for comp in (pm.energy_model, pm.hydrology_model):
        Ya = make_update_aux(comp)(Ya, t, "soil")
    return pm, Ya


@pytest.mark.parametrize("variant", ["coupled", "richards", "heat", "no_ice", "icy"])
def test_rhs_with_coeffs_matches_jax_and_the_stage_rhs(variant):
    jm, Y = _variant(variant)
    t = 12.0
    jcompute, jrhs = jax_coefficient_fns(jm)
    jY = Y
    ref = jrhs(jcompute(jY, _aux(jm), t), jY, _aux(jm), t)
    pm, Ya = _port_aux(jm, torch.tensor(t, dtype=torch.float64))
    Yt = state_from_numpy(Y, device="cpu")
    compute, rhs_c = make_coefficient_fns(pm)
    t_t = torch.tensor(t, dtype=torch.float64)
    got = rhs_c(compute(Yt, Ya, t_t), Yt, Ya, t_t)
    stage = make_rhs(pm)(Yt, Ya, t_t)
    assert got["soil"].keys() == ref["soil"].keys() == stage["soil"].keys()
    for k in ref["soil"]:
        r = np.asarray(ref["soil"][k])
        scale = float(np.max(np.abs(r))) or 1.0
        np.testing.assert_allclose(got["soil"][k].numpy(), r, rtol=1e-13, atol=1e-13 * scale, err_msg=k)
        np.testing.assert_allclose(got["soil"][k].numpy(), stage["soil"][k].numpy(), rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=f"stage/{k}")


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_eager_lagged_run_matches_golden(engine):
    """64 lagged steps of golden #1 reproduce golden_lagged_f64.npz at rtol
    1e-13 on both engines (the fused one takes its plain version on the
    CPU), and differ from the stage golden."""
    model, Y, Ya, dt = gct.build_model_and_state(torch.float64, "cpu")
    model = dataclasses.replace(model, coefficient_update="step")
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, gct.N_STEPS * dt),
                     engine=engine, steps_per_call=16)
    assert isinstance(sim.stepper, LaggedCoefficientStepper)
    sim.run()
    final = state_to_numpy(sim.Y)["soil"]
    golden = np.load(GOLDEN_LAGGED)
    for k in FIELDS:
        np.testing.assert_allclose(final[k], golden[k], rtol=1e-13, atol=1e-18, err_msg=k)
    assert np.max(np.abs(final["vartheta_l"] - np.load(GOLDEN_STAGE)["vartheta_l"])) > 0.0


CASES = {
    "lagged": ({"coefficient_update": "step"}, "B2"),
    "lagged_no_ice": ({"coefficient_update": "step", "assume_no_ice": True}, "B2-no-ice"),
    "no_ice": ({"assume_no_ice": True}, "B1-no-ice"),
}


@pytest.mark.parametrize("bcs", ["golden", "dirichlet_flux"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_fused_run_matches_jax_fused_kernel(case, bcs):
    """The port's fused run (plain version on the CPU) == the JAX Pallas
    kernel in interpret mode, 4 steps from t0 = 30; rtol 1e-12.  Golden #1
    has a free-drainage bottom, whose flux takes the stage state's K."""
    kw, name = CASES[case]
    if bcs == "golden":
        jm, Y, _, dt = gc.build_model_and_state(jnp.float64)
        tile = gc.NCOL
    else:
        jm, Y, dt, tile = _model(JDirichlet(lambda t: 0.4), JVerticalFlux(0.0)), _state(), 5.0, 128
    jm = dataclasses.replace(jm, **kw)
    ref = jax_fused(jm, JSSPRK33(), dt=dt, steps_per_call=4, tile_cols=tile, interpret=True)(Y, 30.0)
    Yt = state_from_numpy(Y, device="cpu")
    run = ck.make_fused_column_run(model_from_reference(jm, device="cpu"), SSPRK33(), dt=dt, steps_per_call=4)
    assert ck.mode_name(run.mode) == name
    run(Yt, 30.0)
    got = state_to_numpy(Yt)["soil"]
    for k in FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(ref["soil"][k]), rtol=1e-12, atol=1e-16, err_msg=k)


def test_lagged_run_conserves_mass_and_energy():
    """With zero-flux BCs the lagged rhs stays in flux form: the column's
    water and energy totals hold to rel 1e-12 over 200 steps."""
    model = dataclasses.replace(
        gct.build_model_and_state(torch.float64, "cpu")[0],
        coefficient_update="step",
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
    )
    Y0, Ya = gct.build_model_and_state(torch.float64, "cpu")[1:3]
    sim = Simulation(model, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=2.0, tspan=(0.0, 400.0))
    sim.run()
    dz = 1.2 / gct.NZ
    for total in (water_mass, energy_total):
        a, b = total(Y0, dz), total(sim.Y, dz)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12)
    assert float((sim.Y["soil"]["vartheta_l"] - Y0["soil"]["vartheta_l"]).abs().max()) > 1e-6


def test_lagged_forward_euler_matches_stage():
    """One rhs evaluation per step at the state the coefficients came from:
    the lagged ForwardEuler trajectory is the stage one to rtol 1e-11 (the
    bar of test_lagged_coefficients.py)."""
    model, Y, Ya, _ = gct.build_model_and_state(torch.float64, "cpu")
    kw = dict(Y_init=Y, Ya_init=Ya, dt=1.0, tspan=(0.0, 60.0))
    stage = Simulation(model, ForwardEuler(), **kw)
    stage.run()
    lagged = Simulation(dataclasses.replace(model, coefficient_update="step"), ForwardEuler(), **kw)
    lagged.run()
    for k in FIELDS:
        b = stage.Y["soil"][k].numpy()
        scale = float(np.max(np.abs(b))) or 1.0
        np.testing.assert_allclose(lagged.Y["soil"][k].numpy(), b, rtol=1e-11, atol=1e-11 * scale, err_msg=k)


def test_validation():
    model = gct.build_model_and_state(torch.float64, "cpu")[0]
    with pytest.raises(ValueError, match="coefficient_update"):
        dataclasses.replace(model, coefficient_update="sometimes")
    prescribed = dataclasses.replace(
        model, energy_model=PrescribedTemperatureModel(), hydrology_model=PrescribedHydrologyModel(),
        coefficient_update="step",
    )
    with pytest.raises(ValueError, match="dynamic"):
        make_coefficient_fns(prescribed)
    stage_model = model
    wrapped = LaggedCoefficientStepper(inner=SSPRK33(), model=stage_model)
    with pytest.raises(ValueError, match="LaggedCoefficientStepper"):
        ck.make_fused_column_run(stage_model, wrapped)
    lagged = dataclasses.replace(model, coefficient_update="step")
    st = wrap_stepper_for_soil(SSPRK33(), lagged)
    assert wrap_stepper_for_soil(st, lagged) is st and wrap_stepper_for_soil(SSPRK33(), model) == SSPRK33()
    assert ck.mode_name(ck.make_fused_column_run(lagged, st).mode) == "B2"


def test_convert_carries_the_step_policies():
    jm = dataclasses.replace(gc.build_model_and_state(jnp.float64)[0], coefficient_update="step",
                             assume_no_ice=True)
    pm = model_from_reference(jm, device="cpu")
    assert (pm.coefficient_update, pm.assume_no_ice, pm.freeze_thaw) == ("step", True, None)
    assert ck.kernel_mode(pm) == ck.MODE_LAGGED | ck.MODE_NO_ICE and ck.scratch_fields(ck.kernel_mode(pm)) == 10


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lagged", "lagged_no_ice", "no_ice"])
def test_cuda_kernel_matches_golden_and_plain(cuda_device, case):
    """f64 golden #1 through each kernel: golden_lagged_f64.npz for the
    lagged modes, golden_coupled_f64.npz for no-ice, and the plain version
    on the card; rtol 1e-12."""
    model, Y, _, dt = gct.build_model_and_state(torch.float64, cuda_device)
    model = dataclasses.replace(model, **CASES[case][0])
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), dt, gct.N_STEPS, Y, 0.0))["soil"]
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=gct.N_STEPS)
    ck.LAUNCHES.clear()
    run(Y, 0.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {CASES[case][1]: 1}
    got = state_to_numpy(Y)["soil"]
    golden = np.load(GOLDEN_STAGE if case == "no_ice" else GOLDEN_LAGGED)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=k)
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-12, atol=1e-16, err_msg=f"plain/{k}")
