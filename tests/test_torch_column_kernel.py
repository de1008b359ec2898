"""The fused column kernel of the PyTorch port (``ops/cuda/column_kernel.py``).

On the CPU the run takes the kernel's plain version; it is held against the
JAX package's fused Pallas kernel (interpret mode) and against
``golden_coupled_f64.npz`` at rtol 1e-12, the bar the Pallas kernel meets.
The host-side pieces the CUDA kernel depends on (BC value tables, the
argument struct, the checks) are tested here too.  Tests marked ``cuda``
launch the CUDA kernel and skip without a GPU.
"""

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
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK22, SSPRK33, ForwardEuler
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


def _assert_close_f64(got, ref, rtol=1e-12):
    for k in FIELDS:
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


class _LandLike:
    soil = None
    surface = None


@pytest.mark.parametrize(
    "mode",
    ["B2_lagged", "B3_freeze_thaw", "B4_stepper", "B5_most", "B6_land",
     "B7_forcing", "B7_time_grid", "B8_geometry", "B9_differentiable"],
)
def test_unported_modes_raise(mode):
    model = _golden_port()
    if mode == "B2_lagged":  # ported: the water-only lagged branch is not
        lagged_water_only = dataclasses.replace(
            model, energy_model=PrescribedTemperatureModel(), coefficient_update="step"
        )
        with pytest.raises(NotImplementedError, match="branch"):
            ck.make_fused_column_run(lagged_water_only)
    elif mode == "B3_freeze_thaw":  # ported: an unknown scheme is refused
        with pytest.raises(TypeError, match="FreezeThaw"):
            dataclasses.replace(model, freeze_thaw=object())
    elif mode == "B4_stepper":
        for stepper in (ForwardEuler(), SSPRK22()):
            with pytest.raises(NotImplementedError, match="B4"):
                ck.make_fused_column_run(model, stepper)
    elif mode == "B5_most":
        with pytest.raises(NotImplementedError, match="A11"):
            PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0,
                                   theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005)
    elif mode == "B6_land":
        with pytest.raises(NotImplementedError, match="A12"):
            ck.make_fused_column_run(_LandLike())
    elif mode == "B7_forcing":
        with pytest.raises(NotImplementedError, match="A14"):
            ck.make_fused_column_run(model, forcing_fields=("u_atm",))
    elif mode == "B7_time_grid":
        with pytest.raises(NotImplementedError, match="A14"):
            ck.make_fused_column_run(model, forcing_time_grid=(0.0, 60.0, 10))
    elif mode == "B8_geometry":
        with pytest.raises(NotImplementedError, match="A13"):
            ck.make_fused_column_run(model, streamed_geometry=(None, None))
    else:
        with pytest.raises(NotImplementedError, match="A17"):
            ck.make_fused_column_run(model, differentiable=True)


def test_unported_branches_and_options_raise():
    """The water-only and heat-only branches still raise; assume_no_ice is
    ported and builds a run of the no-ice kernel."""
    model = _golden_port()
    water_only = dataclasses.replace(model, energy_model=PrescribedTemperatureModel())
    with pytest.raises(NotImplementedError, match="branch"):
        ck.make_fused_column_run(water_only)
    heat_only = dataclasses.replace(model, hydrology_model=PrescribedHydrologyModel())
    with pytest.raises(NotImplementedError, match="branch"):
        ck.make_fused_column_run(heat_only)
    run = ck.make_fused_column_run(dataclasses.replace(model, assume_no_ice=True))
    assert ck.mode_name(run.mode) == "B1-no-ice"


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
    """PARAM_NAMES, BC_SLOTS and _KernelArgs follow the enums and the struct
    of csrc/column_kernel.cu, field by field, every field 8 bytes wide."""
    src = ck.SOURCE.read_text()
    params = re.search(r"enum Param \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in params.split(",") if n.strip()]
    assert names == ["P_" + n.upper() for n in ck.PARAM_NAMES] + ["kNumParams"]
    slots = re.search(r"enum BCSlot \{(.*?)\};", src, re.S).group(1)
    assert [n.strip() for n in slots.split(",") if n.strip()] == [
        f"BC_{face.upper()}_{comp.upper()}" for face, comp in ck.BC_SLOTS
    ] + ["kNumBC"]
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
    params, zc, dz, constant_tables = run._inputs(8, torch.device("cpu"))
    tables = ck.bc_tables(model, 0.0, dt, 3, 8, "cpu", reuse=constant_tables)
    scratch = torch.empty(6 * 24 * 8, dtype=torch.float64)
    a = ck.kernel_args(model, fields, scratch, zc, dz, params, tables, 3, dt)
    assert (a.nz, a.ncol, a.n_steps, a.dt, a.dz) == (24, 8, 3, 10.0, 1.2 / 24)
    assert a.mode == 0 and a.rho_cloud_liq == 1.0e3 and a.grav == 9.81
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
