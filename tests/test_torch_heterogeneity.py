"""Per-column BC kinds (``BatchedBC``) and lateral surface coupling in the
PyTorch port, held against the JAX package.

The same numpy-seeded configurations go through the JAX package (XLA, and
its implicit steppers) and through the port on the CPU (the eager engine
and the fused run's plain version), f64 at rtol 1e-12 / atol 1e-15:

- the three tests of ``tests/soil/test_batched_heterogeneous.py``;
- the two cross-component Dirichlet rules: a ``BatchedBC`` column of kind
  DIRICHLET sets its face state only inside its own flux, so a plain
  Dirichlet of the other component sees the center state, and a plain
  Dirichlet's face state enters a batched column's flux;
- ``TRBDF2Soil`` with a batched Dirichlet top, which gets no Dirichlet
  diagonal boost (only a plain ``Dirichlet`` does);
- the energy FREE_DRAINAGE refusal, ``convert`` keeping the kinds integer,
  and the mapping of the kind codes onto the CUDA kernel's enum;
- ``LateralSurfaceCoupling`` against the JAX rhs on an (nx, ny) batch,
  with stage and lagged coefficients, and the fused engine's refusal.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import (
    BatchedBC as JBatchedBC,
    BCKind as JBCKind,
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
    VerticalFlux as JVerticalFlux,
    initialize_states as j_initialize_states,
)
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2Soil
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.heat import (
    volumetric_heat_capacity as j_vhc,
    volumetric_internal_energy as j_vie,
)
from landhydrology_tpu.models.soil.model import LateralSurfaceCoupling as JLateral
from landhydrology_tpu.models.soil.rhs import make_rhs as j_make_rhs
from landhydrology_tpu.models.soil.water import TemperatureDependentViscosity as JViscosity
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import (
    BatchedBC,
    BCKind,
    LateralSurfaceCoupling,
    Simulation,
    SoilComponentBC,
)
from landhydrology_tpu_torch.convert import (
    model_from_reference,
    state_from_numpy,
    state_to_numpy,
    stepper_from_reference,
)
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ = 30
RTOL, ATOL = 1e-12, 1e-15


def _assert_state(port_Y, jax_Y, keys=None, rtol=RTOL, atol=ATOL):
    got = state_to_numpy(port_Y)["soil"]
    for k in keys or got:
        np.testing.assert_allclose(got[k], np.asarray(jax_Y["soil"][k]), rtol=rtol, atol=atol, err_msg=k)


def _jax_run(jm, Y, Ya, dt, n, stepper=None):
    sim = JSimulation(jm, stepper or JSSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, n * dt))
    sim.run()
    return sim.Y


def _jax_steps(jm, Y, Ya, dt, n):
    """``n`` JAX SSPRK33 steps outside ``jit``: the JAX package checks an
    energy ``BatchedBC``'s kinds where they are concrete, which a traced
    ``Simulation`` run is not."""
    rhs, t = j_make_rhs(jm), jnp.asarray(0.0)
    for _ in range(n):
        Y = JSSPRK33().step(rhs, Y, Ya, t, jnp.asarray(dt))
        t = t + dt
    return Y


def _port_run(jm, Y, dt, n, engine, jstepper=None):
    """The port's run of the JAX model ``jm`` from the JAX state ``Y``:
    ``Simulation`` on the eager engine, or the fused run's plain version
    (the CPU path of ``engine="fused"``) in one call of ``n`` steps."""
    model = model_from_reference(jm, device="cpu")
    stepper = SSPRK33() if jstepper is None else stepper_from_reference(jstepper, model, device="cpu")
    Yt = state_from_numpy(Y, device="cpu")
    if engine == "torch":
        sim = Simulation(model, stepper, Y_init=Yt, dt=dt, tspan=(0.0, n * dt))
        sim.run()
        return sim.Y
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n)
    before = dict(ck.LAUNCHES)
    run(Yt, 0.0)
    assert ck.LAUNCHES == before  # CPU tensors: the plain version, no launch
    return Yt


# ---- tests/soil/test_batched_heterogeneous.py ----


def _water_model(bottom, hm, nu, ncol, top=None):
    return JSoilModel(
        domain=JColumn(zlim=(-1.5, 0.0), nelements=NZ, batch_shape=(ncol,)),
        energy_model=JPrescribedT(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=JSoilColumnBC(
            top=JSoilComponentBC(hydrology=top or JDirichlet(lambda t: 0.24)),
            bottom=JSoilComponentBC(hydrology=bottom),
        ),
        soil_param_set=JSoilParams(nu=nu, S_s=1e-3),
    )


def _water_state(jm, value=0.12):
    return j_initialize_states(
        jm, lambda z, m: {"vartheta_l": jnp.full((NZ, *jm.domain.batch_shape), value),
                          "theta_i": jnp.zeros((NZ, *jm.domain.batch_shape))}, 0.0)


_HM = JvanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5, theta_r=0.075)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_mixed_bc_types_match_jax(engine):
    """``test_batched_heterogeneous.py:59``: bottom kinds [FLUX, DIRICHLET,
    FREE_DRAINAGE] in one batch; the port equals JAX's batched run, and
    each column equals the port's own single-column run of that BC."""
    bottom = JBatchedBC(kind=jnp.array([JBCKind.FLUX, JBCKind.DIRICHLET, JBCKind.FREE_DRAINAGE]),
                        value=jnp.array([-1e-7, 0.15, 0.0]))
    jm = _water_model(bottom, _HM, 0.3, 3)
    Y, Ya = _water_state(jm)
    ref = _jax_run(jm, Y, Ya, 0.25, 120)
    got = _port_run(jm, Y, 0.25, 120, engine)
    _assert_state(got, ref, ("vartheta_l",))
    singles = (JVerticalFlux(-1e-7), JDirichlet(lambda t: 0.15), JFreeDrainage())
    for j, bc in enumerate(singles):
        single = _water_model(bc, _HM, 0.3, 1)
        one = _port_run(single, _water_state(single)[0], 0.25, 120, engine)
        np.testing.assert_allclose(state_to_numpy(got)["soil"]["vartheta_l"][:, j],
                                   state_to_numpy(one)["soil"]["vartheta_l"][:, 0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_heterogeneous_van_genuchten_params_match_jax(engine):
    """``test_batched_heterogeneous.py:93``: per-column (n, alpha, Ksat)."""
    hm = JvanGenuchten(n=jnp.asarray([2.5, 3.96]), alpha=jnp.asarray([2.0, 2.7]),
                       Ksat=jnp.asarray([5e-6, 34.0 / 3600.0 / 100.0]), theta_r=0.075)
    jm = _water_model(JFreeDrainage(), hm, 0.287, 2)
    Y, Ya = _water_state(jm)
    _assert_state(_port_run(jm, Y, 0.25, 120, engine), _jax_run(jm, Y, Ya, 0.25, 120), ("vartheta_l",))


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_large_heterogeneous_batch_matches_jax(engine):
    """``test_batched_heterogeneous.py:123``: 1,024 columns of random soils
    and porosities, 50 steps of dt=1; the state stays in [0, 0.52]."""
    rng = np.random.default_rng(0)
    ncol = 1024
    hm = JvanGenuchten(n=jnp.asarray(rng.uniform(1.3, 4.0, ncol)), alpha=jnp.asarray(rng.uniform(1.0, 6.0, ncol)),
                       Ksat=jnp.asarray(rng.uniform(1e-7, 1e-4, ncol)),
                       theta_r=jnp.asarray(rng.uniform(0.0, 0.1, ncol)))
    nu = jnp.asarray(rng.uniform(0.25, 0.5, ncol))
    jm = _water_model(JFreeDrainage(), hm, nu, ncol, top=JVerticalFlux(0.0))
    Y, Ya = j_initialize_states(jm, lambda z, m: {"vartheta_l": jnp.broadcast_to(0.5 * nu, (NZ, ncol)),
                                                  "theta_i": jnp.zeros((NZ, ncol))}, 0.0)
    got = _port_run(jm, Y, 1.0, 50, engine)
    _assert_state(got, _jax_run(jm, Y, Ya, 1.0, 50), ("vartheta_l",))
    out = state_to_numpy(got)["soil"]["vartheta_l"]
    assert np.all(np.isfinite(out)) and np.all(out >= 0.0) and np.all(out <= 0.52)


# ---- the cross-component Dirichlet rules ----


def _coupled(top, bottom, ncol=6, viscosity=False):
    hydrology = JSoilHydrologyModel(hydraulic_model=JvanGenuchten(n=2.2, alpha=2.6, Ksat=2e-6, theta_r=0.05),
                                    viscosity_factor=JViscosity() if viscosity else JSoilHydrologyModel().viscosity_factor)
    return JSoilModel(
        domain=JColumn(zlim=(-1.0, 0.0), nelements=12, batch_shape=(ncol,)),
        energy_model=JSoilEnergyModel(), hydrology_model=hydrology,
        boundary_conditions=JSoilColumnBC(top=top, bottom=bottom),
        soil_param_set=JSoilParams(nu=0.45, S_s=1e-3, rho_c_ds=1.3e6),
    )


def _coupled_state(jm, seed=3):
    rng = np.random.default_rng(seed)
    ncol = jm.domain.batch_shape[0]
    theta = jnp.asarray(0.2 + 0.1 * rng.random((12, ncol)))
    ti = jnp.zeros_like(theta)
    T = jnp.asarray(283.0 + 6.0 * rng.random((12, ncol)))
    return j_initialize_states(jm, lambda z, m: {
        "vartheta_l": theta, "theta_i": ti, "rho_e_int": j_vie(ti, j_vhc(theta, ti, 1.3e6, jps), T, jps)}, 0.0)


_KINDS6 = jnp.array([0, 1, 1, 0, 1, 0], dtype=jnp.int32)
_BOTTOM = JSoilComponentBC(hydrology=JFreeDrainage(), energy=JVerticalFlux(0.0))


def _cross_case(case, batched=True):
    """``energy_plain``: a plain energy Dirichlet top over hydrology kinds
    with DIRICHLET columns; ``water_plain``: energy kinds with DIRICHLET
    columns under a plain hydrology Dirichlet (with temperature-dependent
    viscosity, so the face T enters K).  ``batched=False`` gives the same
    values as plain Dirichlets on every column, which do set the face."""
    if case == "energy_plain":
        water = (JBatchedBC(kind=_KINDS6, value=jnp.where(_KINDS6 == 1, 0.40, -2e-7)) if batched
                 else JDirichlet(0.40))
        return _coupled(JSoilComponentBC(hydrology=water, energy=JDirichlet(lambda t: 293.0 + 1e-3 * t)), _BOTTOM)
    energy = (JBatchedBC(kind=_KINDS6, value=jnp.where(_KINDS6 == 1, 295.0, 3.0)) if batched
              else JDirichlet(295.0))
    return _coupled(JSoilComponentBC(hydrology=JDirichlet(0.41), energy=energy), _BOTTOM, viscosity=True)


@pytest.mark.parametrize("case", ["energy_plain", "water_plain"])
def test_cross_component_dirichlet_matches_jax(case):
    """The rhs and a 12-step run equal JAX's; and on the DIRICHLET columns
    the other component's tendency differs from a plain Dirichlet of the
    same value, so the rule is observable: kappa at the center vartheta_l
    (``energy_plain``), K at the center T (``water_plain``)."""
    jm = _cross_case(case)
    Y, Ya = _coupled_state(jm)
    t = jnp.asarray(7.0)
    ref = j_make_rhs(jm)(Y, Ya, t)["soil"]
    model = model_from_reference(jm, device="cpu")
    Yt = state_from_numpy(Y, device="cpu")
    got = state_to_numpy(make_rhs(model)(Yt, state_from_numpy(Ya, device="cpu"),
                                         torch.tensor(7.0, dtype=torch.float64)))["soil"]
    for k in ("vartheta_l", "rho_e_int"):
        scale = float(np.max(np.abs(np.asarray(ref[k]))))
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL, atol=1e-13 * scale, err_msg=k)
    plain = j_make_rhs(_cross_case(case, batched=False))(Y, Ya, t)["soil"]
    other = "rho_e_int" if case == "energy_plain" else "vartheta_l"
    dirichlet = np.asarray(_KINDS6) == 1
    top = np.abs(got[other][-1] - np.asarray(plain[other])[-1])
    assert np.all(top[dirichlet] > 1e-9 * np.abs(got[other][-1][dirichlet]))
    ref = _jax_steps(jm, Y, Ya, 2.0, 12)
    for engine in ("torch", "fused"):
        _assert_state(_port_run(jm, Y, 2.0, 12, engine), ref, ("vartheta_l", "rho_e_int"))


def test_trbdf2_batched_dirichlet_top_gets_no_boost():
    """TR-BDF2 on a batched top (FLUX and DIRICHLET columns) equals JAX's
    TRBDF2Soil, on both engines; the same values as a plain Dirichlet on an
    all-DIRICHLET batch end elsewhere (the plain Dirichlet's diagonal
    boost), so the batched kernel must not boost."""
    kinds = jnp.array([1, 0, 1, 1], dtype=jnp.int32)
    top = JBatchedBC(kind=kinds, value=jnp.where(kinds == 1, 0.26, -1e-6))
    jm = _water_model(JFreeDrainage(), _HM, 0.3, 4, top=top)
    Y, Ya = _water_state(jm)
    from landhydrology_tpu.domains import make_function_space as j_grid

    jst = JTRBDF2Soil(model=jm, grid=j_grid(jm.domain, jnp.float64), iters=2)
    ref = _jax_run(jm, Y, Ya, 20.0, 3, stepper=jst)
    for engine in ("torch", "fused"):
        _assert_state(_port_run(jm, Y, 20.0, 3, engine, jstepper=jst), ref, ("vartheta_l",))
    all_dir = _water_model(JFreeDrainage(), _HM, 0.3, 4,
                           top=JBatchedBC(kind=jnp.ones(4, dtype=jnp.int32), value=0.26))
    plain = _water_model(JFreeDrainage(), _HM, 0.3, 4, top=JDirichlet(0.26))
    ends = []
    for m in (all_dir, plain):
        st = JTRBDF2Soil(model=m, grid=j_grid(m.domain, jnp.float64), iters=2)
        ends.append(state_to_numpy(_port_run(m, Y, 20.0, 3, "fused", jstepper=st))["soil"]["vartheta_l"])
    assert np.max(np.abs(ends[0] - ends[1])) > 1e-6


# ---- refusals, conversion, the kernel's kind codes ----


def test_energy_free_drainage_kind_is_refused():
    with pytest.raises(ValueError, match="FREE_DRAINAGE"):
        JSoilComponentBC(energy=JBatchedBC(kind=jnp.array([0, 2]), value=0.0))
    with pytest.raises(ValueError, match="FREE_DRAINAGE"):
        SoilComponentBC(energy=BatchedBC(kind=torch.tensor([0, BCKind.FREE_DRAINAGE]), value=0.0))
    SoilComponentBC(energy=BatchedBC(kind=torch.tensor([0, 1]), value=0.0),
                    hydrology=BatchedBC(kind=torch.tensor([2, 0]), value=0.0))


def test_convert_keeps_integer_kinds_and_float64_depths():
    from landhydrology_tpu import VariableDepthColumn as JVDC

    bottom = JBatchedBC(kind=jnp.array([0, 1, 2], dtype=jnp.int32), value=jnp.array([-1e-7, 0.15, 0.0]))
    jm = dataclasses.replace(
        _water_model(bottom, _HM, 0.3, 3),
        domain=JVDC(z_bottom=jnp.asarray([-0.8, -1.5, -3.0], dtype=jnp.float32), nelements=NZ, batch_shape=(3,)),
    )
    for dtype in (torch.float64, torch.float32):
        model = model_from_reference(jm, device="cpu", dtype=dtype)
        bc = model.boundary_conditions.bottom.hydrology
        assert bc.kind.dtype == torch.int32 and bc.kind.tolist() == [0, 1, 2]
        assert bc.value.dtype == dtype
        zb = model.domain.z_bottom
        assert isinstance(zb, np.ndarray) and zb.dtype == np.float64
        np.testing.assert_array_equal(zb, np.asarray(jm.domain.z_bottom, dtype=np.float64))
    scalar = model_from_reference(dataclasses.replace(
        jm, boundary_conditions=JSoilColumnBC(top=jm.boundary_conditions.top, bottom=JSoilComponentBC(
            hydrology=JBatchedBC(kind=jnp.asarray(2), value=0.0)))), device="cpu")
    assert scalar.boundary_conditions.bottom.hydrology.kind == 2


def test_kind_codes_map_onto_the_kernel_enum():
    """BCKind FLUX 0 / DIRICHLET 1 / FREE_DRAINAGE 2 become the header's
    BC_FLUX 1 / BC_DIRICHLET 2 / BC_FREE_DRAINAGE 3 (any other code the
    eager select's last branch), once on the host; a BatchedBC slot is
    BC_BATCHED and points at its column of codes."""
    header = ck.HEADER.read_text()
    enum = dict(re.findall(r"(BC_\w+) = (\d+)", re.search(r"enum BCKind[^{]*\{(.*?)\};", header, re.S).group(1)))
    assert {k: int(v) for k, v in enum.items()} == {
        "BC_NONE": 0, "BC_FLUX": ck.BC_FLUX, "BC_DIRICHLET": ck.BC_DIRICHLET,
        "BC_FREE_DRAINAGE": ck.BC_FREE_DRAINAGE, "BC_BATCHED": ck.BC_BATCHED}
    codes = ck.cuda_kind_codes(torch.tensor([BCKind.FLUX, BCKind.DIRICHLET, BCKind.FREE_DRAINAGE, 7]))
    assert codes.dtype == torch.int32 and codes.tolist() == [1, 2, 3, 3]
    bottom = JBatchedBC(kind=jnp.array([0, 1, 2], dtype=jnp.int32), value=jnp.array([-1e-7, 0.15, 0.0]))
    model = model_from_reference(_water_model(bottom, _HM, 0.3, 3), device="cpu")
    run = ck.make_fused_column_run(model, dt=0.25, steps_per_call=2)
    assert run.name == "B1-water+kinds"
    Y = state_from_numpy(_water_state(_water_model(bottom, _HM, 0.3, 3))[0], device="cpu")
    fields = [Y["soil"][k] for k in run.fields]
    args, keep = run.launch_args(fields, None, 0.0, torch.device("cpu"))
    assert list(args.bc_kind) == [0, ck.BC_BATCHED, 0, ck.BC_DIRICHLET]
    kinds = run._kinds(3, torch.device("cpu"))
    assert kinds[1][0].tolist() == [1, 2, 3] and args.bc_kind_col[1] == kinds[1][0].data_ptr()
    assert list(args.bc_kind_col_stride) == [0, 1, 0, 0] and args.bc_kind_col[3] is None
    assert args.dz_col is None and args.dz == 1.5 / NZ and (args.zc_level_stride, args.zc_col_stride) == (1, 0)
    coupled = model_from_reference(_coupled(JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0)),
                                            JSoilComponentBC(hydrology=JBatchedBC(kind=_KINDS6 + 1, value=0.3),
                                                             energy=JVerticalFlux(0.0))), device="cpu")
    assert ck.make_fused_column_run(coupled).name == "B1+kinds"
    # B1-no-ice with kinds: the column-tile kernel's instance, whose no-ice rhs caps at nu - theta_i
    run = ck.make_fused_column_run(dataclasses.replace(coupled, assume_no_ice=True))
    assert run.name == "B1-no-ice+kinds" and ck._entry(run.mode, torch.float64)[0] == "tile_columns_kernel"


# ---- lateral surface coupling ----

NX, NY, LZ = 8, 8, 12


def _lateral_model(water_only=False, coefficient_update="stage"):
    """``tests/parallel/test_sharding.py::_model`` with
    ``LateralSurfaceCoupling(5e-4, 1.0)``, coupled or water-only."""
    top = JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0))
    bottom = JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0))
    if water_only:
        top, bottom = (JSoilComponentBC(hydrology=JVerticalFlux(0.0)) for _ in range(2))
    return JSoilModel(
        domain=JColumn(zlim=(-1.0, 0.0), nelements=LZ, batch_shape=(NX, NY)),
        energy_model=JPrescribedT() if water_only else JSoilEnergyModel(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=JvanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5,
                                                                          theta_r=0.0)),
        boundary_conditions=JSoilColumnBC(top=top, bottom=bottom),
        soil_param_set=JSoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        lateral_coupling=JLateral(conductance=5e-4, dx=1.0),
        coefficient_update=coefficient_update,
    )


def _lateral_state(jm):
    x = np.arange(NX)[None, :, None]
    y = np.arange(NY)[None, None, :]
    bump = 0.05 * np.sin(2 * np.pi * x / NX) * np.cos(2 * np.pi * y / NY)

    def ic(z, m):
        theta = jnp.asarray(0.2 + bump + 0.0 * z)
        ti = jnp.zeros_like(theta)
        out = {"vartheta_l": theta, "theta_i": ti}
        if isinstance(m.energy_model, JSoilEnergyModel):
            T = 288.0 + 5.0 * z + 0.0 * theta
            out["rho_e_int"] = j_vie(ti, j_vhc(theta, ti, 1.3e6, jps), T, jps)
        return out

    return j_initialize_states(jm, ic, 0.0)


@pytest.mark.parametrize("branch", ["coupled", "water"])
def test_lateral_rhs_matches_jax(branch):
    jm = _lateral_model(water_only=branch == "water")
    Y, Ya = _lateral_state(jm)
    ref = j_make_rhs(jm)(Y, Ya, jnp.asarray(0.0))["soil"]
    model = model_from_reference(jm, device="cpu")
    assert isinstance(model.lateral_coupling, LateralSurfaceCoupling)
    Yt = state_from_numpy(Y, device="cpu")
    Yat = state_from_numpy(Ya, device="cpu")
    got = state_to_numpy(make_rhs(model)(Yt, Yat, torch.tensor(0.0, dtype=torch.float64)))["soil"]
    top = np.asarray(ref["vartheta_l"])[-1]
    assert np.max(np.abs(top)) > 1e-8  # the lateral term moves the top cells
    for k in got:
        scale = float(np.max(np.abs(np.asarray(ref[k])))) or 1.0
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=RTOL, atol=1e-13 * scale, err_msg=k)


@pytest.mark.parametrize("coefficient_update", ["stage", "step"])
def test_lateral_simulation_matches_jax_and_conserves(coefficient_update):
    """30 steps of dt=10, with stage or lagged coefficients: the port's
    eager engine equals JAX's XLA engine, conserves the column water to
    1e-12 and flattens the surface bump."""
    jm = _lateral_model(coefficient_update=coefficient_update)
    Y, Ya = _lateral_state(jm)
    ref = _jax_run(jm, Y, Ya, 10.0, 30)
    got = _port_run(jm, Y, 10.0, 30, "torch")
    _assert_state(got, ref)
    v0, vf = np.asarray(Y["soil"]["vartheta_l"]), state_to_numpy(got)["soil"]["vartheta_l"]
    assert abs(vf.sum() - v0.sum()) / v0.sum() < 1e-12
    assert vf[-1].std() < v0[-1].std()


def test_fused_engine_refuses_lateral_coupling():
    """Both packages' fused kernels refuse cross-column coupling with a
    ValueError naming it, before the batch-rank check."""
    from landhydrology_tpu.ops.pallas import make_fused_column_run as j_fused

    jm = _lateral_model()
    with pytest.raises(ValueError, match="lateral"):
        j_fused(jm, JSSPRK33(), interpret=True)
    model = model_from_reference(jm, device="cpu")
    with pytest.raises(ValueError, match="lateral"):
        ck.make_fused_column_run(model)
    Y = state_from_numpy(_lateral_state(jm)[0], device="cpu")
    with pytest.raises(ValueError, match="lateral"):
        Simulation(model, SSPRK33(), Y_init=Y, dt=10.0, tspan=(0.0, 20.0), engine="fused")
    with pytest.raises(ValueError, match="2-D"):
        make_rhs(dataclasses.replace(model, domain=dataclasses.replace(model.domain, batch_shape=(NX * NY,))))(
            {"soil": {k: v.reshape(LZ, NX * NY) for k, v in Y["soil"].items()}},
            {"zc": torch.zeros(LZ, 1, dtype=torch.float64), "soil": {}}, torch.tensor(0.0, dtype=torch.float64))
