"""The fused column kernels of the PyTorch port (``ops/cuda/column_kernel.py``).

On the CPU the run takes the kernel's plain version; it is held against the
JAX package's fused Pallas kernel (interpret mode), against the JAX
package's implicit steppers and against ``golden_coupled_f64.npz`` at rtol
1e-12, the bar the Pallas kernel meets.  The host-side pieces the CUDA
kernels depend on (BC value and profile tables at the steppers' stage
times, the argument struct, the modes, the checks) are tested here too.
Tests marked ``cuda`` launch the CUDA kernels and skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import ctypes
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import Dirichlet as JDirichlet
from landhydrology_tpu import FreeDrainage as JFreeDrainage
from landhydrology_tpu import VerticalFlux as JVerticalFlux
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedAtmosForcing,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilModel,
    VerticalFlux,
)
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil
from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK22, SSPRK33, SSPRK104, ForwardEuler
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct
from tests.test_pallas_kernel import _model, _state

GOLDEN = "tests/data/golden_coupled_f64.npz"
FIELDS = ("vartheta_l", "theta_i", "rho_e_int")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _assert_close_f64(got, ref, rtol=1e-12, keys=FIELDS):
    for k in keys:
        np.testing.assert_allclose(
            np.asarray(got[k], dtype=np.float64), np.asarray(ref[k]), rtol=rtol, atol=1e-16, err_msg=k
        )


def test_plain_run_matches_golden_in_place():
    model, Y, _, dt = gct.build_model_and_state(torch.float64, "cpu")
    tensors = [Y["soil"][k] for k in FIELDS]
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=gct.N_STEPS)
    before = dict(ck.LAUNCHES)
    out = run(Y, 0.0)
    assert out is Y and all(Y["soil"][k] is t for k, t in zip(FIELDS, tensors))
    assert ck.LAUNCHES == before  # the CPU path launches no kernel
    _assert_close_f64(state_to_numpy(Y)["soil"], np.load(GOLDEN))


def _heterogeneous_jax(base, ncol):
    rng = np.random.default_rng(3)
    from landhydrology_tpu.models.soil import vanGenuchten

    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.5, 3.5, ncol)),
        alpha=jnp.asarray(rng.uniform(1.5, 4.0, ncol)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-5, ncol)),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.05, ncol)),
    )
    return dataclasses.replace(
        base,
        hydrology_model=dataclasses.replace(base.hydrology_model, hydraulic_model=hm),
        soil_param_set=dataclasses.replace(
            base.soil_param_set, nu=jnp.asarray(rng.uniform(0.45, 0.55, ncol))
        ),
    )


def _jax_case(case):
    """(JAX model, JAX state, dt, tile) for the JAX fused kernel."""
    if case == "golden":
        jm, Y, _, dt = gc.build_model_and_state(jnp.float64)
        return jm, Y, dt, 8
    if case == "flux_free_drainage":
        return _model(JVerticalFlux(0.0), JFreeDrainage()), _state(), 5.0, 128
    if case == "dirichlet_flux":
        return _model(JDirichlet(lambda t: 0.4), JVerticalFlux(0.0)), _state(), 5.0, 128
    base = _model(JVerticalFlux(0.0), JFreeDrainage())
    return _heterogeneous_jax(base, base.domain.batch_shape[0]), _state(), 5.0, 128


@pytest.mark.parametrize("case", ["golden", "flux_free_drainage", "dirichlet_flux", "heterogeneous"])
def test_plain_run_matches_jax_fused_kernel(case):
    """The port's fused run (plain version on the CPU) == the JAX package's
    Pallas kernel in interpret mode, from a non-zero t0."""
    jm, Y, dt, tile = _jax_case(case)
    spc, t0 = 4, 30.0
    ref = jax_fused(jm, JSSPRK33(), dt=dt, steps_per_call=spc, tile_cols=tile, interpret=True)(Y, t0)
    Yt = state_from_numpy(Y, device="cpu")
    ck.make_fused_column_run(model_from_reference(jm, device="cpu"), SSPRK33(), dt=dt, steps_per_call=spc)(Yt, t0)
    _assert_close_f64(state_to_numpy(Yt)["soil"], {k: np.asarray(v) for k, v in ref["soil"].items()})


def test_ragged_column_count_runs():
    """ncol = 13 is no multiple of the 32-column tile: it runs (the JAX
    kernel requires divisibility) and matches the JAX eager SSPRK33 loop."""
    import jax

    jm = dataclasses.replace(
        _model(JDirichlet(lambda t: 0.4), JFreeDrainage()),
        domain=Column(zlim=(-2.0, 0.0), nelements=16, batch_shape=(13,)),
    )
    Y = {"soil": {k: v[:, :13] for k, v in _state()["soil"].items()}}
    from landhydrology_tpu.domains import make_function_space

    grid = make_function_space(jm.domain, jnp.float64)
    rhs = jax_make_rhs(jm, grid)
    Yr = Y
    for i in range(6):
        Yr = JSSPRK33().step(rhs, Yr, {"zc": grid.zc, "soil": {}}, jnp.asarray(2.0 + i * 5.0), jnp.asarray(5.0))
    Yt = state_from_numpy(Y, device="cpu")
    ck.make_fused_column_run(model_from_reference(jm, device="cpu"), SSPRK33(), dt=5.0, steps_per_call=6, tile_cols=32)(Yt, 2.0)
    _assert_close_f64(state_to_numpy(Yt)["soil"], jax.tree_util.tree_map(np.asarray, Yr)["soil"])


@pytest.mark.parametrize(
    "value,shape",
    [
        (0.31, ()),
        (torch.linspace(0.3, 0.4, 5, dtype=torch.float64), (5,)),
        (lambda t: 290.0 + 0.01 * t, ()),
        (lambda t: 0.3 + 1e-4 * t * torch.arange(5, dtype=torch.float64), (5,)),
    ],
    ids=["constant", "per_column", "callable", "callable_per_column"],
)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bc_value_table_matches_direct_calls(value, shape, dtype):
    """Row 3*i + s of a BC table == the BC value called at stage s of step
    i, at the stage times the plain SSPRK33 step uses."""
    n, ncol, t0, dt = 4, 5, 7.5, 0.3
    table, row_stride, col_stride = ck.bc_value_table(value, t0, dt, n, ncol, dtype, "cpu")
    assert table.dtype == dtype and table.is_contiguous()
    assert col_stride == (1 if shape else 0)
    dt_t = torch.as_tensor(dt, dtype=dtype)
    for i, t in enumerate(ck.step_times(t0, dt, n, dtype)):
        for s, ts in enumerate((t, t + dt_t, t + 0.5 * dt_t)):
            direct = torch.as_tensor(value(ts) if callable(value) else value, dtype=dtype)
            for col in range(ncol):
                got = table.reshape(-1)[(3 * i + s) * row_stride + col * col_stride]
                assert got == direct.expand(shape)[col if shape else ()], (i, s, col)


def test_constant_bc_tables_are_reused_across_launches():
    """Tables of constant BC values are built once per column count; the
    tables of callable values follow the launch's t0."""
    model, _, _, dt = gct.build_model_and_state(torch.float64, "cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=3)
    inputs = run._inputs(8, torch.device("cpu"))
    assert run._inputs(8, torch.device("cpu")) is inputs
    constant_tables = inputs[3]
    tables = ck.bc_tables(model, 40.0, dt, 3, 8, "cpu", reuse=constant_tables)
    fresh = ck.bc_tables(model, 40.0, dt, 3, 8, "cpu")
    for (face, comp), table, cached, direct in zip(ck.BC_SLOTS, tables, constant_tables, fresh):
        bc = getattr(getattr(model.boundary_conditions, face), comp)
        if direct is None:
            assert table is None and cached is None
            continue
        value = bc.flux if isinstance(bc, VerticalFlux) else bc.state_value
        assert (table is cached) == (not callable(value))
        assert torch.equal(table[0], direct[0]) and table[1:] == direct[1:]


def test_step_times_follow_the_kernel_arithmetic():
    ts = ck.step_times(1.0, 0.1, 4, torch.float32)
    expect = [torch.tensor(1.0, dtype=torch.float32) + torch.tensor(float(i), dtype=torch.float32)
              * torch.tensor(0.1, dtype=torch.float32) for i in range(4)]
    assert all(a.dtype == torch.float32 and a == b for a, b in zip(ts, expect))


def _golden_port():
    return gct.build_model_and_state(torch.float64, "cpu")[0]


@pytest.mark.parametrize(
    "mode",
    ["B2_lagged", "B3_freeze_thaw", "B4_stepper", "B5_most", "B6_land",
     "B7_forcing", "B7_time_grid", "B8_geometry", "B9_differentiable"],
)
def test_unported_modes_raise(mode):
    model = _golden_port()
    if mode == "B2_lagged":  # ported, on the water-only and heat-only branches too (rk_kernel.cu)
        for branch, name in zip(_branch_models(model), ("B2-water", "B2-heat")):
            lagged = dataclasses.replace(branch, coefficient_update="step")
            assert ck.make_fused_column_run(lagged).name == name
            assert ck.make_fused_column_run(dataclasses.replace(lagged, assume_no_ice=True)).name == name + "-no-ice"
            assert ck._entry(ck.make_fused_column_run(lagged).mode, torch.float64)[0] == "rk_kernel"
        # with per-column BC kinds in them: the stage table's MODE_COLUMNS instance (ROADMAP B1-batched)
        from landhydrology_tpu_torch import BatchedBC

        water_only = _branch_models(model)[0]
        bcs = water_only.boundary_conditions
        kinds = dataclasses.replace(water_only, coefficient_update="step", boundary_conditions=SoilColumnBC(
            top=bcs.top, bottom=SoilComponentBC(hydrology=BatchedBC(kind=torch.zeros(8, dtype=torch.int64),
                                                                    value=0.0), energy=bcs.bottom.energy)))
        run = ck.make_fused_column_run(kinds)
        assert run.name == "B2-water+kinds" and ck._entry(run.mode, torch.float64)[0] == "rk_columns_kernel"
    elif mode == "B3_freeze_thaw":  # ported: an unknown scheme is refused
        with pytest.raises(TypeError, match="FreezeThaw"):
            dataclasses.replace(model, freeze_thaw=object())
    elif mode == "B4_stepper":  # ported, with the step policies and assume_no_ice on the coupled soil
        grid = make_function_space(model.domain, torch.float64, "cpu")
        for kw, name in (({"coefficient_update": "step"}, "B4-trbdf2+B2"),
                         ({"freeze_thaw": FreezeThaw(tau=60.0)}, "B4-trbdf2+B3-rate"),
                         ({"freeze_thaw": EquilibriumFreezeThaw()}, "B4-trbdf2+B3-eq"),
                         ({"assume_no_ice": True}, "B4-trbdf2-no-ice"),
                         ({"coefficient_update": "step", "assume_no_ice": True}, "B4-trbdf2-no-ice+B2")):
            m = dataclasses.replace(model, **kw)
            assert ck.make_fused_column_run(m, TRBDF2Soil(model=m, grid=grid)).name == name
        # the policies on the water-only branch (implicit_branch_kernel.cu); still refused: on the
        # heat-only branch, which the reference kernel cannot run either (ROADMAP B4)
        water = dataclasses.replace(_branch_models(model)[0], coefficient_update="step")
        run = ck.make_fused_column_run(water, TRBDF2Soil(model=water, grid=grid))
        assert run.name == "B4-trbdf2-water+B2"
        assert ck._entry(run.mode, torch.float64)[0] == "implicit_branch_kernel"
        heat = dataclasses.replace(_branch_models(model)[1], coefficient_update="step")
        with pytest.raises(NotImplementedError, match="heat-only branch.*imex.py:231.*ROADMAP B4"):
            ck.make_fused_column_run(heat, TRBDF2Soil(model=heat, grid=grid))
    elif mode in ("B5_most", "B6_land"):  # ported, with freeze-thaw and assume_no_ice, with their rows too
        from landhydrology_tpu_torch.models.land import LandModel

        most = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0,
                                       theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005),
            bottom=model.boundary_conditions.bottom))
        assert ck.mode_name(ck.make_fused_column_run(most).mode) == "B5"
        for kw, suffix in (({"freeze_thaw": FreezeThaw(tau=60.0)}, "+B3-rate"), ({"assume_no_ice": True}, "-no-ice")):
            m = dataclasses.replace(most, **kw)
            item = "B5" if mode == "B5_most" else "B6"
            m = m if mode == "B5_most" else LandModel(soil=m)
            assert ck.make_fused_column_run(m).name == item + suffix
            assert ck.make_fused_column_run(m, forcing_fields=("u_atm",)).name == item + suffix + "+B7"
    elif mode == "B7_forcing":  # ported, under freeze-thaw too: not onto a top without an atmosphere
        with pytest.raises(TypeError, match="PrescribedAtmosForcing"):
            ck.make_fused_column_run(model, forcing_fields=("u_atm",))
        most = dataclasses.replace(model, freeze_thaw=FreezeThaw(tau=60.0), boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0,
                                       theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005),
            bottom=model.boundary_conditions.bottom))
        assert ck.make_fused_column_run(most, forcing_fields=("u_atm",)).name == "B5+B3-rate+B7"
        # the other explicit steppers with rows under MOST too (land_policy_rk_kernel.cu's stage table)
        from landhydrology_tpu_torch.timestepping import SSPRK22

        run = ck.make_fused_column_run(most, SSPRK22(), forcing_fields=("u_atm",))
        assert run.name == "B5+B3-rate+B7@SSPRK22"
        assert ck._entry(run.mode, torch.float64)[0] == "land_policy_rk_kernel"
    elif mode == "B7_time_grid":  # ported, with the implicit steppers too; a grid needs rows
        with pytest.raises(ValueError, match="requires forcing_fields"):
            ck.make_fused_column_run(model, forcing_time_grid=(0.0, 60.0, 10))
        most = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0,
                                       theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005),
            bottom=model.boundary_conditions.bottom))
        grid = make_function_space(model.domain, torch.float64, "cpu")
        run = ck.make_fused_column_run(most, TRBDF2Soil(model=most, grid=grid), forcing_fields=("u_atm",),
                                       forcing_time_grid=(0.0, 60.0, 10))
        assert run.name == "B4-trbdf2+B5+B7-time"
        # B4+B5 with lagged coefficients or freeze-thaw, with rows too; still refused: B4 with a
        # LandModel, which the reference kernel cannot run either (ROADMAP B4)
        from landhydrology_tpu_torch.models.land import LandModel

        with pytest.raises(NotImplementedError, match="ROADMAP B4"):
            ck.make_fused_column_run(LandModel(soil=most), TRBDF2Soil(model=most, grid=grid))
        lagged = dataclasses.replace(most, coefficient_update="step")
        run = ck.make_fused_column_run(lagged, TRBDF2Soil(model=lagged, grid=grid), forcing_fields=("u_atm",))
        assert run.name == "B4-trbdf2+B2+B5+B7"
        frozen = dataclasses.replace(most, freeze_thaw=FreezeThaw(tau=60.0))
        run = ck.make_fused_column_run(frozen, TRBDF2Soil(model=frozen, grid=grid), forcing_fields=("u_atm",),
                                       forcing_time_grid=(0.0, 60.0, 10))
        assert run.name == "B4-trbdf2+B3-rate+B5+B7-time"
        assert ck._entry(run.mode, torch.float64)[0] == "implicit_most_kernel"
    elif mode == "B8_geometry":  # ported, of the model's shape; not with TR-BDF2 on the heat-only branch
        grid = make_function_space(model.domain, torch.float64, "cpu")
        geometry = (torch.full((8,), 0.05, dtype=torch.float64), grid.zc.expand(24, 8).contiguous())
        assert ck.make_fused_column_run(model, streamed_geometry=geometry).name == "B1+B8"
        run = ck.make_fused_column_run(dataclasses.replace(model, freeze_thaw=EquilibriumFreezeThaw()),
                                       streamed_geometry=geometry)
        assert run.name == "B3-eq+B8" and ck._entry(run.mode, torch.float64)[0] == "rk_columns_kernel"
        heat_only = _branch_models(model)[1]
        with pytest.raises(NotImplementedError, match=r"ROADMAP B8, not queued"):
            ck.make_fused_column_run(heat_only, TRBDF2Soil(model=heat_only, grid=grid), streamed_geometry=geometry)
        with pytest.raises(ValueError, match="streamed_geometry has shapes"):
            ck.make_fused_column_run(model, streamed_geometry=(geometry[0][:4], geometry[1]))
        with pytest.raises(TypeError, match="pair of tensors"):
            ck.make_fused_column_run(model, streamed_geometry=(None, None))
    else:  # ported (B9): the plain soil column; a LandModel stays refused, as in JAX
        from landhydrology_tpu_torch.models.land import LandModel

        assert ck.make_fused_column_run(model, differentiable=True).name == "B9:B1"
        with pytest.raises(NotImplementedError, match="differentiable"):
            ck.make_fused_column_run(LandModel(soil=model), differentiable=True)


def _branch_models(model):
    """The water-only and heat-only variants of ``model``; the prescribed
    component's BC slots hold NoBC."""
    from landhydrology_tpu_torch import NoBC

    bcs = model.boundary_conditions
    water_only = dataclasses.replace(
        model, energy_model=PrescribedTemperatureModel(),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=bcs.top.hydrology),
                                         bottom=SoilComponentBC(hydrology=bcs.bottom.hydrology, energy=NoBC())),
    )
    heat_only = dataclasses.replace(
        model, hydrology_model=PrescribedHydrologyModel(),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(energy=bcs.top.energy),
                                         bottom=SoilComponentBC(energy=bcs.bottom.energy)),
    )
    return water_only, heat_only


def test_unported_branches_and_options_raise():
    """The water-only and heat-only branches build runs of kernels B1-water
    and B1-heat (BC slots of the prescribed component hold NoBC, as in
    bench.py::build_stiff); assume_no_ice builds B1-no-ice, and on the
    branches B1-water-no-ice / B1-heat-no-ice; ForwardEuler, SSPRK22 and
    SSPRK104 build their instances on every branch (``@<stepper>``), and
    under a MOST top those of the land kernel (``B5@<stepper>``)."""
    model = _golden_port()
    water_only, heat_only = _branch_models(model)
    assert ck.mode_name(ck.make_fused_column_run(water_only).mode) == "B1-water"
    assert ck.mode_name(ck.make_fused_column_run(heat_only).mode) == "B1-heat"
    run = ck.make_fused_column_run(dataclasses.replace(model, assume_no_ice=True))
    assert ck.mode_name(run.mode) == "B1-no-ice"
    for m, name in ((model, "B1"), (water_only, "B1-water"), (heat_only, "B1-heat")):
        for stepper in (ForwardEuler(), SSPRK22(), SSPRK104()):
            run = ck.make_fused_column_run(m, stepper)
            assert run.name == f"{name}@{type(stepper).__name__}"
            assert ck._entry(run.mode, torch.float64)[0] == "rk_kernel"
    for m, name in ((water_only, "B1-water-no-ice"), (heat_only, "B1-heat-no-ice")):
        assert ck.make_fused_column_run(dataclasses.replace(m, assume_no_ice=True)).name == name
    most = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2,
                                   q_atm=0.005),
        bottom=model.boundary_conditions.bottom))
    for stepper in (ForwardEuler(), SSPRK22(), SSPRK104()):
        run = ck.make_fused_column_run(most, stepper)
        assert run.name == f"B5@{type(stepper).__name__}"
        assert ck._entry(run.mode, torch.float64)[0] == "land_rk_kernel"


def test_mode_names_and_scratch():
    """Every new mode's name, from the model and the stepper, and its
    scratch: the implicit kernel keeps the iterate, the stage constants,
    F, K, C and the solver's fields."""
    model = _golden_port()
    water_only, heat_only = _branch_models(model)
    grid = make_function_space(model.domain, torch.float64, "cpu")
    names = {}
    for m in (model, water_only, heat_only):
        for cls in (TRBDF2Soil, BackwardEulerRichards, BackwardEulerSoil):
            for tridiag in ("thomas", "pcr"):
                try:
                    run = ck.make_fused_column_run(m, cls(model=m, grid=grid, tridiag=tridiag))
                except TypeError:  # backward Euler needs the dynamic components it solves
                    continue
                names[ck.mode_name(run.mode)] = run.mode
                assert ck.scratch_fields(run.mode) == (17 if tridiag == "pcr" else 11)
    assert sorted(names) == sorted(
        base + pcr for base in ("B4-trbdf2", "B4-trbdf2-water", "B4-trbdf2-heat", "B4-be-richards",
                                "B4-be-richards-water", "B4-be-soil") for pcr in ("", "-pcr")
    )
    assert names["B4-trbdf2-water-pcr"] == ck.MODE_TRBDF2 | ck.MODE_WATER | ck.MODE_PCR
    assert ck.kernel_mode(water_only) == ck.MODE_WATER and ck.kernel_mode(heat_only) == ck.MODE_HEAT
    assert ck.scratch_fields(ck.MODE_WATER) == ck.scratch_fields(ck.MODE_HEAT) == 6


def test_implicit_factory_checks():
    model = _golden_port()
    water_only, heat_only = _branch_models(model)
    grid = make_function_space(model.domain, torch.float64, "cpu")
    other = dataclasses.replace(model)
    with pytest.raises(ValueError, match="run's model"):
        ck.make_fused_column_run(model, TRBDF2Soil(model=other, grid=grid))
    with pytest.raises(ValueError, match="tridiagonal"):
        ck.make_fused_column_run(model, TRBDF2Soil(model=model, grid=grid, tridiag="lu"))
    with pytest.raises(TypeError, match="hydrology"):
        ck.make_fused_column_run(heat_only, BackwardEulerRichards(model=heat_only, grid=grid))
    with pytest.raises(TypeError, match="BackwardEulerSoil"):
        ck.make_fused_column_run(water_only, BackwardEulerSoil(model=water_only, grid=grid))
    from landhydrology_tpu_torch.models.soil.water import TemperatureDependentViscosity

    visc = dataclasses.replace(water_only, hydrology_model=dataclasses.replace(
        water_only.hydrology_model, viscosity_factor=TemperatureDependentViscosity()))
    ck.make_fused_column_run(visc)  # SSPRK33 reads T from the profile
    with pytest.raises(NotImplementedError, match="ROADMAP B4"):
        ck.make_fused_column_run(visc, TRBDF2Soil(model=visc, grid=grid))
    # a prescribed component with a Dirichlet or free-drainage slot
    bad = dataclasses.replace(water_only, boundary_conditions=dataclasses.replace(
        water_only.boundary_conditions, top=SoilComponentBC(hydrology=Dirichlet(0.3), energy=Dirichlet(290.0))))
    with pytest.raises(TypeError, match="prescribed energy"):
        ck.make_fused_column_run(bad)


def test_per_column_profiles_are_refused(monkeypatch):
    """Per-column profiles (kernel mode B8) are tabulated per column, one
    (nz, ncol) row per stage time, and refused past the table budget with
    the table's size in the message."""
    model = _golden_port()
    water_only, _ = _branch_models(model)
    per_column = dataclasses.replace(
        water_only, energy_model=PrescribedTemperatureModel(lambda z, t: 280.0 + t + z * torch.arange(8.0)))
    zc = make_function_space(per_column.domain, torch.float64, "cpu").zc
    times = [torch.tensor(t, dtype=torch.float64) for t in (0.0, 1.0, 2.5)]
    table = ck.profile_tables(per_column, zc, times)[0]
    assert table.shape == (3, 24, 8) and table.is_contiguous()
    assert torch.equal(table[2], 282.5 + zc * torch.arange(8.0))
    monkeypatch.setattr(ck, "PROFILE_TABLE_BYTES", 3 * 24 * 8 * 8 - 1)
    with pytest.raises(ValueError, match="takes 4608 B per launch"):
        ck.profile_tables(per_column, zc, times)
    (table, vl, ti) = ck.profile_tables(water_only, zc, [torch.tensor(t, dtype=torch.float64) for t in (0.0, 1.0)])
    assert vl is None and ti is None and table.shape == (2, 24) and torch.all(table == 288.0)


def _recording(log, value):
    def v(t):
        log.append(float(t))
        return value(t) if callable(value) else value
    return v


@pytest.mark.parametrize("stepper", ["SSPRK33", "TRBDF2Soil", "BackwardEulerRichards"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tables_are_built_at_the_eager_stage_times(stepper, dtype):
    """A recording BC callable and a recording T profile see the same times
    from the plain fused run (the eager steps) and from the table builders,
    and the tables hold each value at its row, on the water-only branch
    (BackwardEulerSoil, which needs dynamic heat, evaluates at the times of
    BackwardEulerRichards: tests/test_torch_imex.py)."""
    from landhydrology_tpu_torch import NoBC

    model = _golden_port()
    water_only, _ = _branch_models(model)
    eager_log, table_log, prof_eager, prof_table = [], [], [], []

    def make(bc_log, prof_log):
        top = SoilComponentBC(hydrology=Dirichlet(_recording(bc_log, lambda t: 0.31 + 1e-5 * t)), energy=NoBC())
        profile = _recording(prof_log, lambda t: 285.0 + 1e-3 * t)
        return dataclasses.replace(
            water_only, dtype=dtype,
            energy_model=PrescribedTemperatureModel(lambda z, t: profile(t) + 0.0 * z),
            boundary_conditions=dataclasses.replace(water_only.boundary_conditions, top=top),
            soil_param_set=dataclasses.replace(water_only.soil_param_set, nu=water_only.soil_param_set.nu.to(dtype)),
            hydrology_model=dataclasses.replace(water_only.hydrology_model, hydraulic_model=dataclasses.replace(
                water_only.hydrology_model.hydraulic_model,
                **{f: getattr(water_only.hydrology_model.hydraulic_model, f).to(dtype) for f in ("n", "alpha", "Ksat", "theta_r")})),
        )

    m_eager, m_table = make(eager_log, prof_eager), make(table_log, prof_table)
    grid = make_function_space(m_eager.domain, dtype, "cpu")
    if stepper == "SSPRK33":
        st_eager = st_table = SSPRK33()
    else:
        cls = {"TRBDF2Soil": TRBDF2Soil, "BackwardEulerRichards": BackwardEulerRichards}[stepper]
        st_eager, st_table = cls(model=m_eager, grid=grid), cls(model=m_table, grid=grid)
    _, Y, _, _ = gct.build_model_and_state(dtype, "cpu")
    Y = {"soil": {k: Y["soil"][k] for k in ("vartheta_l", "theta_i")}}
    t0, dt, n = 7.25, 3.3, 3
    ck.fused_column_run_plain(m_eager, st_eager, dt, n, Y, t0)
    times, rows = ck.table_times(st_table, t0, dt, n, dtype)
    table = ck.bc_value_table(m_table.boundary_conditions.top.hydrology.state_value, t0, dt, n, 8, dtype,
                              "cpu", stepper=st_table)
    ck.profile_tables(m_table, grid.zc, times)
    assert rows == {"SSPRK33": 3, "TRBDF2Soil": 3, "BackwardEulerRichards": 1}[stepper]
    assert sorted(set(eager_log)) == sorted(set(table_log)) == sorted(set(float(t) for t in times))
    assert sorted(set(prof_eager)) == sorted(set(prof_table)) == sorted(set(table_log))
    assert table[1:] == (1, 0) and table[0].shape == (len(times),)
    for r, t in enumerate(times):
        assert table[0][r] == torch.as_tensor(0.31 + 1e-5 * t, dtype=dtype)


def _implicit_jax_case(case):
    """(JAX model, state, dt) of the implicit plain-run cases."""
    import bench

    if case == "golden":
        jm, Y, _, _ = gc.build_model_and_state(jnp.float64)
        return jm, Y, 120.0
    if case == "stiff":
        jm, Y, _ = bench.build_stiff(16, 6, jnp.float64)
        return jm, Y, 5.0
    base = _model(JVerticalFlux(0.0), JVerticalFlux(0.0))
    return _heterogeneous_jax(base, base.domain.batch_shape[0]), _state(), 300.0


@pytest.mark.parametrize(
    "case,stepper,tridiag",
    [("golden", "TRBDF2Soil", "thomas"), ("golden", "TRBDF2Soil", "pcr"),
     ("golden", "BackwardEulerRichards", "thomas"), ("golden", "BackwardEulerSoil", "pcr"),
     ("stiff", "TRBDF2Soil", "thomas"), ("stiff", "BackwardEulerRichards", "pcr"),
     ("heterogeneous", "TRBDF2Soil", "thomas")],
)
def test_plain_implicit_run_matches_jax_steps(case, stepper, tridiag):
    """The port's fused run with an implicit stepper (plain version on the
    CPU) == the JAX package's stepper over the same steps, from t0 = 10;
    rtol 1e-12.  (The JAX fused kernel runs these steppers in its body, and
    its own tests hold it to them.)"""
    import landhydrology_tpu.imex as jimex
    from landhydrology_tpu.domains import make_function_space as jax_grid

    jm, Y, dt = _implicit_jax_case(case)
    jgrid = jax_grid(jm.domain, jnp.float64)
    jst = getattr(jimex, stepper)(model=jm, grid=jgrid, iters=2, tridiag=tridiag)
    rhs = jax_make_rhs(jm, jgrid)
    Yt = state_from_numpy(Y, device="cpu")
    Ya = {"zc": jgrid.zc, "soil": {}}
    for i in range(3):
        Y = jst.step(rhs, Y, Ya, jnp.asarray(10.0 + i * dt), jnp.asarray(dt))
    model = model_from_reference(jm, device="cpu")
    import landhydrology_tpu_torch.imex as imex

    st = getattr(imex, stepper)(model=model, grid=make_function_space(model.domain, torch.float64, "cpu"),
                                iters=2, tridiag=tridiag)
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=3)
    before = dict(ck.LAUNCHES)
    run(Yt, 10.0)
    assert ck.LAUNCHES == before
    _assert_close_f64({k: v for k, v in state_to_numpy(Yt)["soil"].items()},
                      {k: np.asarray(v) for k, v in Y["soil"].items()}, keys=tuple(Y["soil"]))


def test_plain_heat_only_run_matches_eager_steps():
    """Heat-only TR-BDF2 and SSPRK33 through the fused run (plain version)
    == the port's eager steps (the JAX TR-BDF2 raises on a heat-only model;
    tests/test_torch_imex.py holds the port's to the JAX sweeps)."""
    from landhydrology_tpu_torch.models.soil.rhs import make_rhs

    _, heat_only = _branch_models(_golden_port())
    heat_only = dataclasses.replace(heat_only, hydrology_model=PrescribedHydrologyModel(
        vartheta_l_profile=lambda z, t: 0.3 + 0.05 * z + 1e-5 * t, theta_i_profile=lambda z, t: 0.01 + 0.0 * z))
    grid = make_function_space(heat_only.domain, torch.float64, "cpu")
    _, Y0, _, dt = gct.build_model_and_state(torch.float64, "cpu")
    Y0 = {"soil": {"rho_e_int": Y0["soil"]["rho_e_int"]}}
    for st, dt in ((TRBDF2Soil(model=heat_only, grid=grid, iters=2), 300.0), (SSPRK33(), 10.0)):
        Y = Y0
        Ya = {"zc": grid.zc, "soil": {}}
        for t in ck.step_times(4.0, dt, 3, torch.float64):
            Y = st.step(make_rhs(heat_only, grid), Y, Ya, t, torch.tensor(dt, dtype=torch.float64))
        Yt = {"soil": {"rho_e_int": Y0["soil"]["rho_e_int"].clone()}}
        ck.make_fused_column_run(heat_only, st, dt=dt, steps_per_call=3)(Yt, 4.0)
        assert torch.equal(Yt["soil"]["rho_e_int"], Y["soil"]["rho_e_int"])
        assert not torch.equal(Y["soil"]["rho_e_int"], Y0["soil"]["rho_e_int"])


def test_factory_rejects_bad_configuration():
    model = _golden_port()
    for tile in (0, 100, 2048):
        with pytest.raises(ValueError, match="tile_cols"):
            ck.make_fused_column_run(model, tile_cols=tile)
    with pytest.raises(ValueError, match="steps_per_call"):
        ck.make_fused_column_run(model, steps_per_call=0)
    no_energy_bc = SoilColumnBC(
        top=SoilComponentBC(hydrology=Dirichlet(0.3)),
        bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0)),
    )
    with pytest.raises(ValueError, match="NoBC"):
        ck.make_fused_column_run(dataclasses.replace(model, boundary_conditions=no_energy_bc))
    energy_drainage = SoilColumnBC(
        top=model.boundary_conditions.top,
        bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=FreeDrainage()),
    )
    with pytest.raises(TypeError, match="FreeDrainage"):
        ck.make_fused_column_run(dataclasses.replace(model, boundary_conditions=energy_drainage))
    grid2d = dataclasses.replace(model, domain=Column(zlim=(-1.2, 0.0), nelements=24, batch_shape=(2, 4)))
    with pytest.raises(ValueError, match="1-D column batch"):
        ck.make_fused_column_run(grid2d)


def test_argument_struct_mirrors_the_cuda_source():
    """PARAM_NAMES, BC_SLOTS, PROFILE_NAMES, the MODE_* bits and _KernelArgs
    follow the enums and the struct of csrc/column_common.cuh, field by
    field, every field 8 bytes wide."""
    src = ck.HEADER.read_text()
    params = re.search(r"enum Param \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in params.split(",") if n.strip()]
    assert names == ["P_" + n.upper() for n in ck.PARAM_NAMES] + ["kNumParams"]
    slots = re.search(r"enum BCSlot \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in slots.split(",") if n.strip()] == [
        f"BC_{face.upper()}_{comp.upper()}" for face, comp in ck.BC_SLOTS
    ] + ["kNumBC"]
    profiles = re.search(r"enum Profile \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in profiles.split(",") if n.strip()] == [
        "PROF_" + n.upper() for n in ck.PROFILE_NAMES
    ] + ["kNumProfiles"]
    surface = re.search(r"enum Surface \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in surface.split(",") if n.strip()] == [
        "S_" + n.upper() for n in ck.SURFACE_NAMES
    ] + ["kNumSurface"]
    modes = dict(re.findall(r"(MODE_\w+) = (\d+)", re.search(r"enum Mode[^{]*\{(.*?)\};", src, re.S).group(1)))
    assert modes and all(getattr(ck, k) == int(v) for k, v in modes.items())
    body = re.search(r"struct KernelArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        names = re.sub(r"^(const\s+)?\w+\*?\s+", "", decl)  # drop the type
        fields += [re.sub(r"\[.*?\]", "", n).strip() for n in names.split(",")]
    assert fields == [f[0] for f in ck._KernelArgs._fields_]
    assert all(
        ctypes.sizeof(t) % 8 == 0 and getattr(ck._KernelArgs, n).offset % 8 == 0
        for n, t in ck._KernelArgs._fields_
    )


def test_kernel_args_pack_the_golden_model():
    model, Y, _, dt = gct.build_model_and_state(torch.float64, "cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=3)
    fields = [Y["soil"][k] for k in FIELDS]
    params, zc, dz, constant_tables = run._inputs(8, torch.device("cpu"))[:4]
    tables = ck.bc_tables(model, 0.0, dt, 3, 8, "cpu", reuse=constant_tables)
    scratch = torch.empty(6 * 24 * 8, dtype=torch.float64)
    a = ck.kernel_args(model, fields, scratch, zc, dz, params, tables, 3, dt)
    assert (a.nz, a.ncol, a.n_steps, a.dt, a.dz) == (24, 8, 3, 10.0, 1.2 / 24)
    assert a.mode == 0 and a.rho_cloud_liq == 1.0e3 and a.grav == 9.81
    assert (a.rows_per_step, a.iters) == (3, 0) and not any(a.profile)
    grid = make_function_space(model.domain, torch.float64, "cpu")
    b = ck.kernel_args(model, fields, scratch, zc, dz, params, tables, 3, dt,
                       stepper=TRBDF2Soil(model=model, grid=grid, iters=3, tridiag="pcr"))
    assert b.mode == ck.MODE_TRBDF2 | ck.MODE_PCR and (b.rows_per_step, b.iters) == (3, 3)
    g = 2.0 - 2.0 ** 0.5
    assert (b.half_g, b.b_bdf2) == (0.5 * g, (1.0 - g) / (2.0 - g))
    c = ck.kernel_args(model, fields, scratch, zc, dz, params, tables, 3, dt,
                       stepper=BackwardEulerSoil(model=model, grid=grid))
    assert c.mode == ck.MODE_BE_SOIL and (c.rows_per_step, c.iters) == (1, 2)
    assert list(a.bc_kind) == [1, 3, 2, 2]  # flux, free drainage, Dirichlet x2
    nu = dict(zip(ck.PARAM_NAMES, params))["nu"]
    assert nu[1] == 1 and torch.equal(nu[0], model.soil_param_set.nu)
    assert dict(zip(ck.PARAM_NAMES, params))["S_s"][1] == 0  # a scalar: stride 0


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_matches_golden_and_plain(cuda_device, dtype):
    golden = np.load(GOLDEN)
    model, Y, _, dt = gct.build_model_and_state(dtype, cuda_device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), dt, gct.N_STEPS, Y, 0.0))["soil"]
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=gct.N_STEPS)
    ck.LAUNCHES.clear()
    run(Y, 0.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"B1": 1}
    got = state_to_numpy(Y)["soil"]
    if dtype == torch.float64:
        _assert_close_f64(got, golden)
        _assert_close_f64(got, plain)
    else:
        np.testing.assert_allclose(got["vartheta_l"], plain["vartheta_l"], rtol=0, atol=2e-4)
        rel = np.abs(got["rho_e_int"] - plain["rho_e_int"]) / (np.abs(plain["rho_e_int"]) + 1e3)
        assert np.max(rel) < 5e-4


@pytest.mark.cuda
def test_cuda_kernel_ragged_columns(cuda_device):
    model, Y, _, dt = gct.build_model_and_state(torch.float64, cuda_device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), dt, 5, Y, 3.0))["soil"]
    ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=5, tile_cols=32)(Y, 3.0)
    torch.cuda.synchronize()
    _assert_close_f64(state_to_numpy(Y)["soil"], plain)


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_state(cuda_device):
    model, Y, _, dt = gct.build_model_and_state(torch.float64, cuda_device)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=2)
    bad = {"soil": dict(Y["soil"], rho_e_int=Y["soil"]["rho_e_int"].float())}
    with pytest.raises(ValueError, match="float64"):
        run(bad, 0.0)
    strided = {"soil": {k: torch.cat([v, v], dim=1)[:, ::2] for k, v in Y["soil"].items()}}
    with pytest.raises(ValueError, match="contiguous"):
        run(strided, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("tridiag", ["thomas", "pcr"])
def test_cuda_implicit_kernel_matches_golden_and_plain(cuda_device, tridiag):
    """Golden #6 through kernel B4-trbdf2: rtol 1e-12 against
    golden_implicit_f64.npz with Thomas, atol 1e-9 with PCR; rtol 1e-12
    against the plain version on the card."""
    golden = np.load("tests/data/golden_implicit_f64.npz")
    model, Y, _, _ = gct.build_model_and_state(torch.float64, cuda_device)
    st = TRBDF2Soil(model=model, grid=make_function_space(model.domain, torch.float64, cuda_device), iters=3,
                    tridiag=tridiag)
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, 120.0, 16, Y, 0.0))["soil"]
    run = ck.make_fused_column_run(model, st, dt=120.0, steps_per_call=16)
    ck.LAUNCHES.clear()
    run(Y, 0.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"B4-trbdf2" + ("-pcr" if tridiag == "pcr" else ""): 1}
    got = state_to_numpy(Y)["soil"]
    _assert_close_f64(got, plain)
    if tridiag == "thomas":
        _assert_close_f64(got, golden)
    else:
        np.testing.assert_allclose(got["vartheta_l"], golden["vartheta_l"], rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", ["SSPRK33", "TRBDF2Soil"])
@pytest.mark.parametrize("branch", ["water", "heat"])
def test_cuda_branch_kernels_match_plain(cuda_device, stepper, branch):
    """B1-water, B1-heat, B4-trbdf2-water and B4-trbdf2-heat on golden #1's
    column against the plain version on the card, f64 rtol 1e-12."""
    model, Y, _, _ = gct.build_model_and_state(torch.float64, cuda_device)
    water_only, heat_only = _branch_models(model)
    m = water_only if branch == "water" else heat_only
    keys = ("vartheta_l", "theta_i") if branch == "water" else ("rho_e_int",)
    Y = {"soil": {k: Y["soil"][k] for k in keys}}
    st = SSPRK33() if stepper == "SSPRK33" else TRBDF2Soil(
        model=m, grid=make_function_space(m.domain, torch.float64, cuda_device), iters=2)
    dt = 10.0 if stepper == "SSPRK33" else 120.0
    plain = state_to_numpy(ck.fused_column_run_plain(m, st, dt, 8, Y, 3.0))["soil"]
    ck.LAUNCHES.clear()
    ck.make_fused_column_run(m, st, dt=dt, steps_per_call=8)(Y, 3.0)
    torch.cuda.synchronize()
    assert sum(ck.LAUNCHES.values()) == 1
    _assert_close_f64(state_to_numpy(Y)["soil"], plain, keys=keys)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B5", "B2+B5", "B6", "B6-step", "B2+B6", "B2+B6-step", "B6-pond",
                                  "B6-step-pond", "B2+B6-pond", "B2+B6-step-pond"])
def test_cuda_land_kernels_match_plain(cuda_device, case):
    """Every B5/B6 mode on the LandModel of tests/test_pallas_kernel.py:278
    (its soil alone for B5) against the plain version on the card, f64 rtol
    1e-12 (h_s atol 1e-18); one launch each."""
    from tests.test_torch_land import _jax_land, _jax_land_state

    jm = _jax_land(most="pond" not in case, surface_update="step" if "step" in case else "stage",
                   coefficient_update="step" if case.startswith("B2") else "stage")
    Y, _ = _jax_land_state(jm, 2e-5)
    model = model_from_reference(jm, device=cuda_device)
    Y = state_from_numpy(Y, device=cuda_device)
    if "B5" in case:
        model, Y = model.soil, {"soil": Y["soil"]}
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), 2.0, 8, Y, 3.0))
    ck.LAUNCHES.clear()
    ck.make_fused_column_run(model, SSPRK33(), dt=2.0, steps_per_call=8)(Y, 3.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {case: 1}
    got = state_to_numpy(Y)
    _assert_close_f64(got["soil"], plain["soil"])
    if "surface" in plain:
        np.testing.assert_allclose(got["surface"]["h_s"], plain["surface"]["h_s"], rtol=1e-12, atol=1e-18)


@pytest.mark.cuda
def test_cuda_negative_rain_rate_on_the_card_raises(cuda_device):
    """A rain rate held on the card is checked once, where it is declared."""
    from landhydrology_tpu_torch.models.land import ConstantPrecipitation, PulsePrecipitation

    for cls in (ConstantPrecipitation, PulsePrecipitation):
        with pytest.raises(ValueError, match="non-negative"):
            cls(rate=torch.tensor(-1e-6, dtype=torch.float64, device=cuda_device))
        assert float(cls(rate=torch.tensor(1e-6, device=cuda_device)).rate) == pytest.approx(1e-6)
