"""Variable-depth column batches (``VariableDepthColumn``, kernel mode B8)
in the PyTorch port, held against the JAX package.

Every column keeps ``nz`` cells and its own spacing ``dz``.  The cases of
``tests/test_variable_depth.py`` (the grid, mixed depths, mass, coupled
energy, the fused kernel at ``:237`` and the implicit stepper at ``:272``)
go through the JAX package (XLA, and its fused kernel in interpret mode)
and through the port on the CPU (the eager engine and the fused run's
plain version), f64 at rtol 1e-12 / atol 1e-15.  Also: the f32 grid,
``streamed_geometry`` against the model's own grid, per-column profile
tables, the explicit step limit, and ``experiments/soil/catchment.py``'s
LandModel (kinematic-wave routing over variable regolith) on the eager
engine.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import (
    Column as JColumn,
    Dirichlet as JDirichlet,
    FreeDrainage as JFreeDrainage,
    PrescribedTemperatureModel as JPrescribedT,
    Simulation as JSimulation,
    SoilColumnBC as JSoilColumnBC,
    SoilComponentBC as JSoilComponentBC,
    SoilEnergyModel as JSoilEnergyModel,
    SoilHydrologyModel as JSoilHydrologyModel,
    SoilModel as JSoilModel,
    SoilParams as JSoilParams,
    VariableDepthColumn as JVDC,
    VerticalFlux as JVerticalFlux,
    initialize_states as j_initialize_states,
    make_function_space as j_grid,
)
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.heat import (
    volumetric_heat_capacity as j_vhc,
    volumetric_internal_energy as j_vie,
)
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import Column, Simulation, VariableDepthColumn, make_function_space
from landhydrology_tpu_torch.convert import (
    model_from_reference,
    state_from_numpy,
    state_to_numpy,
    stepper_from_reference,
)
from landhydrology_tpu_torch.diagnostics import explicit_dt_limit
from landhydrology_tpu_torch.models.soil import initialize_states
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ = 24
DEPTHS = [0.8, 1.5, 3.0]
RTOL, ATOL = 1e-12, 1e-15


def _richards(domain, bottom=None, top=None):
    return JSoilModel(
        domain=domain,
        energy_model=JPrescribedT(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=JvanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5,
                                                                          theta_r=0.075)),
        boundary_conditions=JSoilColumnBC(
            top=JSoilComponentBC(hydrology=top or JDirichlet(lambda t: 0.24)),
            bottom=JSoilComponentBC(hydrology=bottom or JFreeDrainage()),
        ),
        soil_param_set=JSoilParams(nu=0.3, S_s=1e-3),
    )


def _ic(z, m):
    return {"vartheta_l": jnp.full_like(z, 0.12), "theta_i": jnp.zeros_like(z)}


def _depths(values=DEPTHS):
    return JVDC(z_bottom=-jnp.asarray(values), nelements=NZ, batch_shape=(len(values),))


def _jax_run(jm, Y, Ya, dt, n, stepper=None):
    sim = JSimulation(jm, stepper or JSSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, n * dt))
    sim.run()
    return sim.Y


def _port_run(jm, Y, dt, n, engine, jstepper=None, steps_per_call=None):
    model = model_from_reference(jm, device="cpu")
    stepper = SSPRK33() if jstepper is None else stepper_from_reference(jstepper, model, device="cpu")
    Yt = state_from_numpy(Y, device="cpu")
    if engine == "torch":
        sim = Simulation(model, stepper, Y_init=Yt, dt=dt, tspan=(0.0, n * dt))
        sim.run()
        return sim.Y
    spc = steps_per_call or n
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc)
    assert "+B8" in run.name
    t = torch.tensor(0.0, dtype=torch.float64)
    for _ in range(n // spc):
        run(Yt, t)
        t = t + spc * dt
    return Yt


def _assert_state(port_Y, jax_Y, keys=None, rtol=RTOL, atol=ATOL):
    got = state_to_numpy(port_Y)["soil"]
    for k in keys or got:
        np.testing.assert_allclose(got[k], np.asarray(jax_Y["soil"][k]), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_grid_matches_jax(dtype):
    """``test_variable_depth.py:60``: ``(nz, 3)`` centers, ``(nz+1, 3)``
    faces and a ``(3,)`` spacing, equal to the JAX grid bit for bit in both
    dtypes (the mesh in float64, then cast; float32 depths stay float64)."""
    jdom = JVDC(z_bottom=-jnp.asarray(DEPTHS, dtype=jnp.float32), nelements=NZ, batch_shape=(3,))
    jdtype = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    ref = j_grid(jdom, jdtype)
    dom = VariableDepthColumn(z_bottom=-torch.tensor(DEPTHS, dtype=torch.float32), nelements=NZ, batch_shape=(3,))
    assert dom.z_bottom.dtype == np.float64
    grid = make_function_space(dom, dtype, "cpu")
    assert grid.zc.shape == (NZ, 3) and grid.zf.shape == (NZ + 1, 3) and grid.dz.shape == (3,)
    for k in ("zc", "zf", "dz"):
        got = getattr(grid, k)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, k)), err_msg=k)
    assert torch.equal(grid.dz_boundary, grid.dz / 2.0)
    np.testing.assert_allclose(dom.height, np.asarray(jdom.height), rtol=0)


def test_rejects_inverted_columns():
    with pytest.raises(ValueError, match="z_bottom < z_top"):
        VariableDepthColumn(z_bottom=[-1.0, 0.5], nelements=NZ, batch_shape=(2,))
    with pytest.raises(ValueError, match="z_bottom < z_top"):
        VariableDepthColumn(z_bottom=-1.0, z_top=np.array([0.0, -2.0]), nelements=NZ, batch_shape=(2,))


def test_equal_depths_match_uniform_column_exactly():
    """``test_variable_depth.py:83``: all-equal depths reproduce the
    uniform column bit for bit, on the eager engine."""
    uniform = _richards(JColumn(zlim=(-1.5, 0.0), nelements=NZ))
    Yu, _ = j_initialize_states(uniform, _ic, 0.0)
    vd = _richards(_depths([1.5] * 4))
    Yv, _ = j_initialize_states(vd, _ic, 0.0)
    one = state_to_numpy(_port_run(uniform, Yu, 0.25, 120, "torch"))["soil"]["vartheta_l"]
    four = state_to_numpy(_port_run(vd, Yv, 0.25, 120, "torch"))["soil"]["vartheta_l"]
    assert four.shape == (NZ, 4)
    for j in range(4):
        np.testing.assert_array_equal(four[:, j], one)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_mixed_depths_match_jax(engine):
    """``test_variable_depth.py:100``: a mixed-depth batch (Dirichlet top
    with the per-column half cell, free drainage below) equals JAX's."""
    jm = _richards(_depths())
    Y, Ya = j_initialize_states(jm, _ic, 0.0)
    _assert_state(_port_run(jm, Y, 0.25, 120, engine), _jax_run(jm, Y, Ya, 0.25, 120), ("vartheta_l",))


def test_mass_conservation_per_column_depth():
    """``test_variable_depth.py:123``: zero-flux faces conserve each
    column's water with its own dz, and the state equals JAX's."""
    jm = _richards(_depths(), bottom=JVerticalFlux(0.0), top=JVerticalFlux(0.0))

    def ic(z, m):
        return {"vartheta_l": 0.12 + 0.08 * jnp.exp(-((z + 0.3) ** 2) / 0.05), "theta_i": jnp.zeros_like(z)}

    Y, Ya = j_initialize_states(jm, ic, 0.0)
    got = _port_run(jm, Y, 0.5, 240, "torch")
    _assert_state(got, _jax_run(jm, Y, Ya, 0.5, 240), ("vartheta_l",))
    dz = make_function_space(model_from_reference(jm, device="cpu").domain, torch.float64, "cpu").dz.numpy()
    v0, v1 = np.asarray(Y["soil"]["vartheta_l"]), state_to_numpy(got)["soil"]["vartheta_l"]
    np.testing.assert_allclose(v1.sum(0) * dz, v0.sum(0) * dz, rtol=1e-12)
    assert np.max(np.abs(v1 - v0)) > 1e-4


def _coupled(domain):
    return JSoilModel(
        domain=domain,
        energy_model=JSoilEnergyModel(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=JvanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5,
                                                                          theta_r=0.075)),
        boundary_conditions=JSoilColumnBC(
            top=JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JDirichlet(lambda t: 290.0)),
            bottom=JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0)),
        ),
        soil_param_set=JSoilParams(nu=0.3, S_s=1e-3),
    )


def _coupled_ic(z, m):
    theta, ti = jnp.full_like(z, 0.15), jnp.zeros_like(z)
    T = jnp.full_like(z, 283.0)
    return {"vartheta_l": theta, "theta_i": ti,
            "rho_e_int": j_vie(ti, j_vhc(theta, ti, m.soil_param_set.rho_c_ds, jps), T, jps)}


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_coupled_energy_on_variable_depth_matches_jax(engine):
    """``test_variable_depth.py:147``: coupled water and energy (a Dirichlet
    energy top) on a mixed-depth batch."""
    jm = _coupled(_depths())
    Y, Ya = j_initialize_states(jm, _coupled_ic, 0.0)
    _assert_state(_port_run(jm, Y, 0.5, 120, engine), _jax_run(jm, Y, Ya, 0.5, 120), ("vartheta_l", "rho_e_int"))


def _kernel_case():
    rng = np.random.default_rng(1)
    jm = _richards(_depths(list(rng.uniform(0.8, 3.0, 8))))
    return jm, j_initialize_states(jm, _ic, 0.0)


def test_fused_plain_matches_jax_kernel():
    """``test_variable_depth.py:237``: 8 columns of U(0.8, 3.0) m, 6 steps
    of dt=0.25 in one launch: the JAX fused kernel (interpret mode, dz and
    zc streamed as tiled inputs) and the port's fused run (plain version)."""
    from landhydrology_tpu.ops.pallas import make_fused_column_run as j_fused

    jm, (Y, Ya) = _kernel_case()
    ref = j_fused(jm, JSSPRK33(), dt=0.25, steps_per_call=6, tile_cols=4, interpret=True)(Y, 0.0)
    _assert_state(_port_run(jm, Y, 0.25, 6, "fused"), ref, ("vartheta_l",))


def test_streamed_geometry_equals_the_model_grid():
    """``streamed_geometry=(dz, zc)`` on a uniform-column model gives the
    variable-depth model's run bit for bit when the rows are that model's
    grid, and equals the JAX fused kernel fed the same rows."""
    from landhydrology_tpu.ops.pallas import make_fused_column_run as j_fused

    jm, (Y, _) = _kernel_case()
    model = model_from_reference(jm, device="cpu")
    grid = make_function_space(model.domain, torch.float64, "cpu")
    flat = dataclasses.replace(model, domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(8,)))
    runs = []
    for m, geometry in ((model, None), (flat, (grid.dz, grid.zc)), (model, (grid.dz, grid.zc))):
        Yt = state_from_numpy(Y, device="cpu")
        run = ck.make_fused_column_run(m, SSPRK33(), dt=0.25, steps_per_call=6, streamed_geometry=geometry)
        assert run.name == "B1-water+B8"
        runs.append(state_to_numpy(run(Yt, 0.0))["soil"]["vartheta_l"])
    assert np.array_equal(runs[0], runs[1]) and np.array_equal(runs[0], runs[2])
    jflat = dataclasses.replace(jm, domain=JColumn(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(8,)))
    ref = j_fused(jflat, JSSPRK33(), dt=0.25, steps_per_call=6, tile_cols=4, interpret=True,
                  streamed_geometry=(jnp.asarray(grid.dz.numpy()), jnp.asarray(grid.zc.numpy())))(Y, 0.0)
    np.testing.assert_allclose(runs[1], np.asarray(ref["soil"]["vartheta_l"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_implicit_stepper_on_variable_depth_matches_jax(engine):
    """``test_variable_depth.py:272``: BackwardEulerRichards(iters=3) at
    dt=15 over 600 s on three depths (the per-column dz in the tridiagonal
    rows and the Dirichlet boost), in launches of 8 steps on the fused
    engine; within 5e-3 of the explicit run, as JAX's test asks."""
    from landhydrology_tpu.imex import BackwardEulerRichards as JBER

    jm = _richards(_depths())
    Y, Ya = j_initialize_states(jm, _ic, 0.0)
    jst = JBER(model=jm, grid=j_grid(jm.domain, jnp.float64), iters=3)
    ref = _jax_run(jm, Y, Ya, 15.0, 40, stepper=jst)
    got = _port_run(jm, Y, 15.0, 40, engine, jstepper=jst, steps_per_call=8)
    _assert_state(got, ref, ("vartheta_l",))
    explicit = state_to_numpy(_port_run(jm, Y, 0.25, 2400, "fused", steps_per_call=240))["soil"]["vartheta_l"]
    np.testing.assert_allclose(state_to_numpy(got)["soil"]["vartheta_l"], explicit, atol=5e-3)


def test_explicit_dt_limit_and_initial_state_per_column():
    """The step limit reads each column's dz, as JAX's does, and the
    initial-condition function receives the ``(nz, ncol)`` centers."""
    from landhydrology_tpu.diagnostics import explicit_dt_limit as j_limit

    jm = _richards(_depths())
    Y, Ya = j_initialize_states(jm, lambda z, m: {"vartheta_l": 0.2 + 0.05 * z, "theta_i": jnp.zeros_like(z)}, 0.0)
    model = model_from_reference(jm, device="cpu")
    seen = []

    def ic(z, m):
        seen.append(z)
        return {"vartheta_l": 0.2 + 0.05 * z, "theta_i": torch.zeros_like(z)}

    Yt, Yat = initialize_states(model, ic, 0.0)
    assert seen[0].shape == (NZ, 3)
    np.testing.assert_array_equal(Yat["zc"].numpy(), np.asarray(Ya["zc"]))
    _assert_state(Yt, Y, rtol=0, atol=0)
    assert float(explicit_dt_limit(model, Yt)) == pytest.approx(float(j_limit(jm, Y)), rel=1e-13)


def test_per_column_profile_tables_on_a_variable_grid():
    """The water-only branch's T profile on a variable grid is one
    ``(nz, ncol)`` row per stage time (time-dependent) or a single row (the
    default profile), each the profile at the columns' own centers; the
    kernel's argument struct walks them by row, level and column."""
    jm = _richards(_depths())
    model = dataclasses.replace(model_from_reference(jm, device="cpu"), energy_model=type(
        model_from_reference(jm, device="cpu").energy_model)(T_profile=lambda z, t: 280.0 + 2.0 * z + 1e-3 * t))
    run = ck.make_fused_column_run(model, dt=0.5, steps_per_call=2)
    _, zc, dz = run._inputs(3, torch.device("cpu"))[:3]
    assert zc.shape == (NZ, 3) and dz.shape == (3,)
    _, profiles, _, _ = run.tables(3, torch.device("cpu"), 1.0)
    times, _ = ck.table_times(run.stepper, 1.0, 0.5, 2, torch.float64)
    assert profiles[0].shape == (6, NZ, 3) and profiles[0].dtype == torch.float64
    for r, t in enumerate(times):
        assert torch.equal(profiles[0][r], 280.0 + 2.0 * zc + 1e-3 * t)
    Y = state_from_numpy(j_initialize_states(jm, _ic, 0.0)[0], device="cpu")
    args, _ = run.launch_args([Y["soil"][k] for k in run.fields], None, 1.0, torch.device("cpu"))
    assert (args.profile_row_stride[0], args.profile_level_stride[0], args.profile_col_stride[0]) == (NZ * 3, 3, 1)
    assert (args.zc_level_stride, args.zc_col_stride, args.dz_col_stride) == (3, 1, 1)
    assert args.dz_col == dz.data_ptr() and args.dz == 0.0
    default = ck.make_fused_column_run(model_from_reference(jm, device="cpu"), dt=0.5, steps_per_call=2)
    table = default.tables(3, torch.device("cpu"), 1.0)[1][0]
    assert table.shape == (1, NZ, 3) and torch.all(table == 288.0)


# ---- experiments/soil/catchment.py's LandModel ----


def _catchment(nx=4, ny=4, nz=6):
    """``catchment.py:85-175`` at a small size: periodic ridge and valley
    terrain, regolith 0.5-2 m (``VariableDepthColumn``), soils coarser
    upslope, a Gaussian storm pulse, ``KinematicWaveRouting``, prescribed T,
    zero-flux faces."""
    from landhydrology_tpu.models.land import KinematicWaveRouting, LandModel, SurfaceWaterModel

    ix, iy = np.arange(nx)[:, None], np.arange(ny)[None, :]
    z_terrain = (4.0 * (1.0 + np.cos(2 * np.pi * ix / nx)) * np.ones((1, ny))
                 + 0.3 * np.sin(2 * np.pi * iy / ny) * np.sin(2 * np.pi * ix / nx))
    z_norm = (z_terrain - z_terrain.min()) / (z_terrain.max() - z_terrain.min())
    depth = 0.5 + 1.5 * (1.0 - z_norm)
    rng = np.random.default_rng(42)
    log_ksat = -6.5 + 1.2 * z_norm + 0.15 * rng.standard_normal((nx, ny))
    hm = JvanGenuchten(n=jnp.asarray(1.8 + 1.2 * z_norm), alpha=jnp.asarray(2.0 + 1.5 * z_norm),
                       Ksat=jnp.asarray(10.0 ** log_ksat), theta_r=0.05)
    soil = JSoilModel(
        domain=JVDC(z_bottom=jnp.asarray(-depth), nelements=nz, batch_shape=(nx, ny)),
        energy_model=JPrescribedT(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=JSoilColumnBC(top=JSoilComponentBC(hydrology=JVerticalFlux(0.0)),
                                          bottom=JSoilComponentBC(hydrology=JVerticalFlux(0.0))),
        soil_param_set=JSoilParams(nu=0.42, S_s=1e-3, rho_c_ds=1.3e6),
    )
    P_peak, t_c, sig = 40.0 / 1000.0 / 3600.0, 60.0, 30.0

    def precip(t):  # serves both packages: t is a JAX array or a tensor
        exp = torch.exp if torch.is_tensor(t) else jnp.exp
        return P_peak * exp(-(((t - t_c) / sig) ** 2))

    return LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=precip, tau_pond=600.0,
        runoff=KinematicWaveRouting(elevation=jnp.asarray(z_terrain), manning_n=0.05, dx=10.0, h_detention=5e-4)))


def test_catchment_land_model_matches_jax():
    """The LandModel of ``catchment.py`` (routing, variable depth) through
    60 steps of dt=2 on the eager engine equals JAX's XLA run: soil, pond
    and the water the storm added."""
    from landhydrology_tpu.models.land import initialize_states as j_land_init

    jland = _catchment()
    Y, Ya = j_land_init(jland, lambda z, m: {"vartheta_l": jnp.full((6, 4, 4), 0.15),
                                              "theta_i": jnp.zeros((6, 4, 4))}, 0.0)
    ref = _jax_run(jland, Y, Ya, 2.0, 60)
    land = model_from_reference(jland, device="cpu")
    assert isinstance(land.soil.domain, VariableDepthColumn)
    sim = Simulation(land, SSPRK33(), Y_init=state_from_numpy(Y, device="cpu"), dt=2.0, tspan=(0.0, 120.0))
    sim.run()
    got = state_to_numpy(sim.Y)
    np.testing.assert_allclose(got["soil"]["vartheta_l"], np.asarray(ref["soil"]["vartheta_l"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["surface"]["h_s"], np.asarray(ref["surface"]["h_s"]), rtol=RTOL, atol=1e-18)
    assert np.max(got["surface"]["h_s"]) > 0.0
    with pytest.raises(ValueError, match="routing"):
        ck.make_fused_column_run(land)
