"""The port's implicit steppers (``imex.py``) against the JAX package's, f64.

- dpsi/dvartheta in closed form (``water.dpsi_dtheta``) and by autograd
  (``dpsi_dtheta_autograd`` below) against ``jax.grad`` of the pressure head,
  on a grid through every branch edge, ties included: rtol 1e-13;
- ``_backward_euler_delta`` with Dirichlet boosts and ``nz == 1``, one water
  sweep and one heat sweep: rtol 1e-13;
- the three steppers over a few steps on golden #1, the stiff infiltration
  (water-only), heterogeneous parameters, viscosity and impedance, PCR, and
  TR-BDF2 with both freeze-thaw schemes: rtol 1e-13;
- TR-BDF2 on a heat-only model against the JAX package's own heat sweep
  composed into the TR-BDF2 stages (the JAX stepper itself raises KeyError
  there): rtol 1e-13;
- the eager TR-BDF2 against ``golden_implicit_f64.npz``: rtol 1e-13;
- ``stages``, ``stage_times`` and ``convert.stepper_from_reference``.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import landhydrology_tpu.imex as jimex
from landhydrology_tpu import (
    Column as JColumn,
    Dirichlet as JDirichlet,
    PrescribedHydrologyModel as JPrescribedHydrologyModel,
    SoilColumnBC as JSoilColumnBC,
    SoilComponentBC as JSoilComponentBC,
    SoilEnergyModel as JSoilEnergyModel,
    SoilModel as JSoilModel,
    SoilParams as JSoilParams,
    VerticalFlux as JVerticalFlux,
)
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.models.soil import IceImpedance as JIceImpedance
from landhydrology_tpu.models.soil import TemperatureDependentViscosity as JTemperatureDependentViscosity
from landhydrology_tpu.models.soil import freeze_thaw as jft
from landhydrology_tpu.models.soil import water as jsw
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch import Column, imex
from landhydrology_tpu_torch.convert import (
    model_from_reference,
    state_from_numpy,
    state_to_numpy,
    stepper_from_reference,
)
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.soil import freeze_thaw as ft
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct
from tests.test_pallas_kernel import _model as pallas_model
from tests.test_pallas_kernel import _state as pallas_state

GOLDEN_IMPLICIT = "tests/data/golden_implicit_f64.npz"
F64 = torch.float64
EPS = float(np.finfo(np.float64).eps)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, rtol=1e-13, atol=1e-18):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


# ---- dpsi / dvartheta_l ----

_HM = {
    # the stiff sand of bench.py::build_stiff
    "sand": dict(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075),
    # alpha**-n = 1e-300: the tiny guard of the log engages close to
    # saturation (S = 1 - 1e-12) and not below (the product stays normal
    # there, so XLA's flush of subnormals on the CPU does not enter)
    "tiny_guard": dict(n=100.0, alpha=1000.0, Ksat=1e-6, theta_r=0.02),
}


def _edge_grid(theta_r, nu_eff):
    """vartheta_l values on and around every branch edge of the pressure
    head: the dry clamp theta_r + eps (a tie), the clip of S at 1 - eps (a
    tie), the next vartheta_l below nu_eff (S on that tie or inside the
    clipped band (1 - eps, 1), as the spacing falls), S == 1 exactly,
    saturation, and the plain region between."""
    width = nu_eff - theta_r
    v_s = lambda S: theta_r + S * width  # noqa: E731
    return np.array([
        0.0, theta_r, theta_r + EPS, theta_r + 2 * EPS, theta_r + 1e-9,
        v_s(0.01), v_s(0.3), v_s(0.7), v_s(0.999), v_s(1 - 1e-12),
        v_s(1 - EPS), np.nextafter(nu_eff, 0.0), nu_eff, nu_eff + 1e-12, nu_eff + 0.01,
    ])


def dpsi_dtheta_autograd(hm, vartheta_l, nu_eff, S_s):
    """``C = d psi / d vartheta_l`` by ``torch.autograd`` of the pressure head
    (the JAX package's ``_dpsi_dtheta`` is ``jax.grad`` of it): a second
    derivation, held with the closed form ``water.dpsi_dtheta`` that the
    steppers and the kernel use against ``jax.grad``.  The clamps are written with ``torch.maximum`` /
    ``torch.minimum``, which split the gradient evenly at a tie as
    ``jnp.maximum`` / ``jnp.clip`` do (``torch.clamp`` would pass it
    whole)."""
    n, alpha, m, theta_r = hm.n, hm.alpha, hm.m, hm.theta_r
    eps = sw._eps_of(vartheta_l)
    tiny = sw._tiny_of(vartheta_l)

    def bound(x, like):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    def head(v):
        S = (torch.maximum(v, bound(theta_r + eps, v)) - theta_r) / (nu_eff - theta_r)
        S_safe = torch.minimum(torch.maximum(S, bound(eps, S)), bound(1.0 - eps, S))
        u_inv = torch.exp(torch.log(S_safe) * (-1.0 / m))
        base = (u_inv - 1.0) * alpha ** (-n)
        psi_unsat = -torch.exp(torch.log(torch.maximum(base, bound(tiny, base))) * (1.0 / n))
        psi_m = torch.where(S < 1.0, psi_unsat, 0.0)
        return torch.where(S <= 1.0, psi_m, (v - nu_eff) / S_s)

    with torch.enable_grad():
        v = vartheta_l.detach().clone().requires_grad_(True)
        (C,) = torch.autograd.grad(head(v).sum(), v)
    return C


@pytest.mark.parametrize("method", ["closed_form", "autograd"])
@pytest.mark.parametrize("soil", ["sand", "tiny_guard"])
def test_dpsi_dtheta_matches_jax_grad(method, soil):
    p = _HM[soil]
    nu, S_s = 0.287 if soil == "sand" else 0.45, 1e-3
    v = _edge_grid(p["theta_r"], nu)
    # the first ties must sit where intended: the dry clamp, the clip
    assert v[2] == p["theta_r"] + EPS
    S = np.asarray(jsw.effective_saturation(nu, jnp.asarray(v), p["theta_r"]))
    assert S[10] == 1 - EPS <= S[11] < 1.0 and S[12] == 1.0 and S[13] > 1.0

    jhm = jsw.vanGenuchten(**p)
    want = np.asarray(jimex._dpsi_dtheta(jhm, jnp.asarray(v), nu, S_s))
    hm = sw.vanGenuchten(**p)
    fn = sw.dpsi_dtheta if method == "closed_form" else dpsi_dtheta_autograd
    got = fn(hm, torch.as_tensor(v), nu, S_s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    # the edges: half at the ties, zero beyond the clamps, 1/S_s saturated
    assert got[0] == got[1] == got[12] == 0.0 and got[13] == got[14] == 1.0 / S_s
    if soil == "sand":
        assert got[10] != 0.0 and got[11] == (got[10] if S[11] == S[10] else 0.0)
    else:  # the tiny guard zeroes the wet end
        assert np.all(got[5:9] != 0.0) and np.all(got[9:12] == 0.0)


def test_dpsi_dtheta_per_column_with_ice():
    """Per-column van Genuchten parameters and nu_eff = nu - theta_i."""
    rng = np.random.default_rng(5)
    ncol = 9
    p = dict(n=rng.uniform(1.5, 3.5, ncol), alpha=rng.uniform(1.5, 4.0, ncol),
             Ksat=rng.uniform(1e-7, 1e-5, ncol), theta_r=rng.uniform(0.0, 0.05, ncol))
    nu = rng.uniform(0.4, 0.5, ncol)
    theta_i = rng.uniform(0.0, 0.1, (12, ncol))
    v = rng.uniform(0.0, 0.55, (12, ncol))
    v[0] = p["theta_r"] + EPS  # dry-clamp ties, column by column
    jhm = jsw.vanGenuchten(**{k: jnp.asarray(x) for k, x in p.items()})
    want = np.asarray(jimex._dpsi_dtheta(jhm, jnp.asarray(v), jnp.asarray(nu - theta_i), 1e-3))
    hm = sw.vanGenuchten(**{k: torch.as_tensor(x) for k, x in p.items()})
    for fn in (sw.dpsi_dtheta, dpsi_dtheta_autograd):
        got = fn(hm, torch.as_tensor(v), torch.as_tensor(nu - theta_i), 1e-3).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


# ---- the tridiagonal assembly and the sweeps ----


@pytest.mark.parametrize("solver", ["thomas", "pcr"])
@pytest.mark.parametrize("case", ["boosts", "no_boost", "single_cell"])
def test_backward_euler_delta_matches_jax(solver, case):
    nz = 1 if case == "single_cell" else 12
    ncol = 5
    rng = np.random.default_rng(11)
    K = rng.uniform(1e-7, 1e-5, (nz, ncol))
    C = rng.uniform(1.0, 50.0, (nz, ncol))
    b = rng.uniform(-1e-3, 1e-3, (nz, ncol))
    boosts = (rng.uniform(-1e-3, 0, ncol), rng.uniform(-1e-3, 0, ncol)) if case != "no_boost" else (0.0, 0.0)
    domain = JColumn(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,))
    want = jimex._backward_euler_delta(
        jnp.asarray(K), jnp.asarray(C), jnp.asarray(b), jnp.asarray(300.0), jax_grid(domain, jnp.float64),
        *(jnp.asarray(x) if np.ndim(x) else x for x in boosts), solver=solver,
    )
    grid = make_function_space(Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,)), F64, "cpu")
    got = imex._backward_euler_delta(
        torch.as_tensor(K), torch.as_tensor(C), torch.as_tensor(b), torch.tensor(300.0, dtype=F64), grid,
        *(torch.as_tensor(x) if np.ndim(x) else x for x in boosts), solver=solver,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-30)


def _stiff_jax(nz, ncol):
    """bench.py::build_stiff on the domain (-1, 0) the sweep tests use."""
    jm, Y, Ya = bench.build_stiff(nz, ncol, jnp.float64)
    return dataclasses.replace(jm, domain=JColumn(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,))), Y, Ya


def _port(jm, Y, Ya):
    return model_from_reference(jm, device="cpu"), state_from_numpy(Y, device="cpu"), state_from_numpy(Ya, device="cpu")


@pytest.mark.parametrize("component", ["water", "heat"])
def test_newton_sweep_matches_jax(component):
    """One sweep of golden #1's coupled column (Dirichlet top in both
    components, free drainage below) from a perturbed iterate, at a stage
    weight and time of TR-BDF2."""
    jm, Y, Ya, _ = gc.build_model_and_state(jnp.float64)
    rng = np.random.default_rng(2)
    key = "vartheta_l" if component == "water" else "rho_e_int"
    scale = 0.02 if component == "water" else 2e5
    it = np.asarray(Y["soil"][key]) + scale * rng.standard_normal(Y["soil"][key].shape)
    c_const = np.array(Y["soil"][key])
    jgrid = jax_grid(jm.domain, jnp.float64)
    jsweep = jimex._water_newton_sweep if component == "water" else jimex._heat_newton_sweep
    Ybase = {"soil": dict(Y["soil"], **{key: jnp.asarray(it)})}
    want = jsweep(jm, jgrid, jax_make_rhs(jm, jgrid), Ybase, Ya, jnp.asarray(it), jnp.asarray(c_const),
                  jnp.asarray(35.0), jnp.asarray(70.0))
    model, Yt, Yat = _port(jm, _np(Ybase), _np(Ya))
    grid = make_function_space(model.domain, F64, "cpu")
    sweep = imex._water_newton_sweep if component == "water" else imex._heat_newton_sweep
    got = sweep(model, grid, make_rhs(model, grid), Yt, Yat, torch.as_tensor(it), torch.as_tensor(c_const),
                torch.tensor(35.0, dtype=F64), torch.tensor(70.0, dtype=F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-18)


def test_water_sweep_matches_jax_on_the_stiff_column():
    """Dirichlet top at the wetting front: the boundary boost with K at the
    Dirichlet value, and the trust clamp."""
    jm, Y, Ya = _stiff_jax(16, 6)
    v0 = np.asarray(Y["soil"]["vartheta_l"])
    jgrid = jax_grid(jm.domain, jnp.float64)
    c_const = v0 + np.linspace(0.0, 0.25, 16)[:, None]  # large updates near the top
    want = jimex._water_newton_sweep(jm, jgrid, jax_make_rhs(jm, jgrid), Y, Ya, Y["soil"]["vartheta_l"],
                                     jnp.asarray(c_const), jnp.asarray(500.0), jnp.asarray(500.0))
    change = np.abs(np.asarray(want) - v0)
    assert np.any(change == 0.5 * 0.287) and np.any(change < 0.1)  # the clamp engaged, not everywhere
    model, Yt, Yat = _port(jm, _np(Y), _np(Ya))
    grid = make_function_space(model.domain, F64, "cpu")
    got = imex._water_newton_sweep(model, grid, make_rhs(model, grid), Yt, Yat, Yt["soil"]["vartheta_l"],
                                   torch.as_tensor(c_const), torch.tensor(500.0, dtype=F64),
                                   torch.tensor(500.0, dtype=F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-18)


# ---- the steppers ----


def _heterogeneous_jax():
    rng = np.random.default_rng(7)
    base = pallas_model(JVerticalFlux(0.0), JVerticalFlux(0.0))
    ncol = base.domain.batch_shape[0]
    hm = jsw.vanGenuchten(
        n=jnp.asarray(rng.uniform(1.8, 3.0, ncol)), alpha=jnp.asarray(rng.uniform(1.5, 4.0, ncol)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-5, ncol)), theta_r=jnp.asarray(rng.uniform(0.0, 0.05, ncol)),
    )
    model = dataclasses.replace(
        base,
        hydrology_model=dataclasses.replace(base.hydrology_model, hydraulic_model=hm),
        soil_param_set=dataclasses.replace(base.soil_param_set, nu=jnp.asarray(rng.uniform(0.45, 0.55, ncol))),
    )
    grid = jax_grid(model.domain, jnp.float64)
    return model, pallas_state(), {"zc": grid.zc, "soil": {}}


def _case(name):
    """(JAX model, state, aux, dt, t0) of a stepper case."""
    if name in ("golden", "viscosity"):
        jm, Y, Ya, _ = gc.build_model_and_state(jnp.float64)
        if name == "viscosity":
            jm = dataclasses.replace(jm, hydrology_model=dataclasses.replace(
                jm.hydrology_model, viscosity_factor=JTemperatureDependentViscosity(),
                impedance_factor=JIceImpedance()))
            Y = {"soil": dict(Y["soil"], theta_i=jnp.full_like(Y["soil"]["theta_i"], 0.02))}
        return jm, Y, Ya, 120.0, 5.0
    if name == "stiff":
        jm, Y, Ya = bench.build_stiff(16, 6, jnp.float64)
        return jm, Y, Ya, 5.0, 1.0
    if name == "heterogeneous":
        jm, Y, Ya = _heterogeneous_jax()
        return jm, Y, Ya, 300.0, 0.0
    scheme = {"freeze_rate": jft.FreezeThaw(tau=60.0), "freeze_eq": jft.EquilibriumFreezeThaw()}[name]
    jm, Y, Ya, _ = gc.build_freeze_model_and_state(jnp.float64)
    return dataclasses.replace(jm, freeze_thaw=scheme), Y, Ya, 20.0, 0.0


@pytest.mark.parametrize(
    "case,stepper,iters,tridiag",
    [
        ("golden", "TRBDF2Soil", 3, "thomas"),
        ("golden", "TRBDF2Soil", 2, "pcr"),
        ("golden", "BackwardEulerRichards", 2, "thomas"),
        ("golden", "BackwardEulerSoil", 2, "thomas"),
        ("viscosity", "TRBDF2Soil", 2, "thomas"),
        ("viscosity", "BackwardEulerSoil", 2, "pcr"),
        ("stiff", "TRBDF2Soil", 2, "thomas"),
        ("stiff", "TRBDF2Soil", 2, "pcr"),
        ("stiff", "BackwardEulerRichards", 2, "thomas"),
        ("heterogeneous", "TRBDF2Soil", 2, "thomas"),
        ("freeze_rate", "TRBDF2Soil", 2, "thomas"),
        ("freeze_eq", "TRBDF2Soil", 2, "thomas"),
        ("freeze_rate", "BackwardEulerSoil", 2, "thomas"),
    ],
)
def test_stepper_matches_jax(case, stepper, iters, tridiag):
    """Three steps of the port's stepper == the JAX stepper's, from t0, with
    the equilibrium projection wrapped around both where the model has it."""
    jm, Y, Ya, dt, t0 = _case(case)
    jgrid = jax_grid(jm.domain, jnp.float64)
    jst = jft.wrap_stepper_with_projection(getattr(jimex, stepper)(model=jm, grid=jgrid, iters=iters, tridiag=tridiag), jm)
    model, Yt, Yat = _port(jm, _np(Y), _np(Ya))
    grid = make_function_space(model.domain, F64, "cpu")
    st = ft.wrap_stepper_with_projection(getattr(imex, stepper)(model=model, grid=grid, iters=iters, tridiag=tridiag), model)
    jrhs, rhs = jax_make_rhs(jm, jgrid), make_rhs(model, grid)
    for i in range(3):
        t = t0 + i * dt
        Y = jst.step(jrhs, Y, Ya, jnp.asarray(t), jnp.asarray(dt))
        Yt = st.step(rhs, Yt, Yat, torch.tensor(t, dtype=F64), torch.tensor(dt, dtype=F64))
    _assert_tree_close(state_to_numpy(Yt)["soil"], _np(Y)["soil"])
    start = _np(_case(case)[1])["soil"]["vartheta_l"] if "vartheta_l" in Y["soil"] else None
    if start is not None:  # the steps moved the water
        assert np.max(np.abs(_np(Y)["soil"]["vartheta_l"] - start)) > 1e-6


def _heat_only_jax():
    """A heat-only column (dry-soil conduction, as tests/soil/test_heat.py)
    with time-varying vartheta_l and theta_i profiles, a callable Dirichlet
    top and a per-column flux bottom."""
    rng = np.random.default_rng(4)
    nz, ncol = 12, 5
    model = JSoilModel(
        domain=JColumn(zlim=(0.0, 1.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=JSoilEnergyModel(),
        hydrology_model=JPrescribedHydrologyModel(
            vartheta_l_profile=lambda z, t: 0.2 + 0.1 * z + 1e-5 * t,
            theta_i_profile=lambda z, t: 0.02 * (1.0 - z) + 0.0 * t,
        ),
        boundary_conditions=JSoilColumnBC(
            top=JSoilComponentBC(energy=JDirichlet(lambda t: 280.0 + 5.0 * np.cos(2 * math.pi * t / 600.0))),
            bottom=JSoilComponentBC(energy=JVerticalFlux(jnp.asarray(rng.uniform(-5.0, 5.0, ncol)))),
        ),
        soil_param_set=JSoilParams(nu=0.45, rho_c_ds=1.1e6, kappa_solid=8.0,
                                   kappa_sat_unfrozen=0.57, kappa_sat_frozen=2.29),
    )
    grid = jax_grid(model.domain, jnp.float64)
    Y = {"soil": {"rho_e_int": jnp.asarray(1e6 * (1.0 + rng.random((nz, ncol))))}}
    return model, grid, Y, {"zc": grid.zc, "soil": {}}


def _jax_trbdf2_heat_only(model, grid, Y, Ya, t, dt, iters, solver):
    """TRBDF2Soil.step of the JAX package for a heat-only model, with the
    prescribed vartheta_l and theta_i at the stage time handed to its heat
    sweep (its own stepper looks them up in the state and raises)."""
    rhs = jax_make_rhs(model, grid)
    hyd = model.hydrology_model
    g = jimex._TRBDF2_GAMMA
    d = 2.0 - g
    a1, a2, b = 1.0 / (g * d), -((1.0 - g) ** 2) / (g * d), (1.0 - g) / d

    def stage(e0, c, w, t_eval):
        water = {"vartheta_l": jnp.broadcast_to(hyd.vartheta_l_profile(Ya["zc"], t_eval), e0.shape),
                 "theta_i": jnp.broadcast_to(hyd.theta_i_profile(Ya["zc"], t_eval), e0.shape)}
        e = e0
        for _ in range(iters):
            e = jimex._heat_newton_sweep(model, grid, rhs, {"soil": dict(water, rho_e_int=e)}, Ya, e, c, w,
                                         t_eval, solver=solver)
        return e

    e_n = Y["soil"]["rho_e_int"]
    f_n = rhs(Y, Ya, t)["soil"]["rho_e_int"]
    w1 = 0.5 * g * dt
    e_star = stage(e_n, e_n + w1 * f_n, w1, t + g * dt)
    e_new = stage(e_star, a1 * e_star + a2 * e_n, b * dt, t + dt)
    return {"soil": {"rho_e_int": e_new}}


@pytest.mark.parametrize("tridiag", ["thomas", "pcr"])
def test_trbdf2_heat_only_matches_jax_sweeps(tridiag):
    jm, jgrid, Y, Ya = _heat_only_jax()
    model, Yt, Yat = _port(jm, _np(Y), _np(Ya))
    grid = make_function_space(model.domain, F64, "cpu")
    st = imex.TRBDF2Soil(model=model, grid=grid, iters=2, tridiag=tridiag)
    rhs = make_rhs(model, grid)
    with pytest.raises(KeyError, match="theta_i"):  # the JAX stepper itself
        jimex.TRBDF2Soil(model=jm, grid=jgrid, iters=2).step(jax_make_rhs(jm, jgrid), Y, Ya, jnp.asarray(0.0),
                                                             jnp.asarray(60.0))
    dt = 60.0
    for i in range(3):
        t = 3.0 + i * dt
        Y = _jax_trbdf2_heat_only(jm, jgrid, Y, Ya, jnp.asarray(t), jnp.asarray(dt), 2, tridiag)
        Yt = st.step(rhs, Yt, Yat, torch.tensor(t, dtype=F64), torch.tensor(dt, dtype=F64))
    _assert_tree_close(state_to_numpy(Yt)["soil"], _np(Y)["soil"])


def test_trbdf2_reproduces_golden_implicit():
    """Golden #6: golden #1 under TRBDF2Soil(iters=3, tridiag="thomas"),
    16 steps of dt=120, built with the port alone."""
    golden = np.load(GOLDEN_IMPLICIT)
    model, Y, Ya, _ = gct.build_model_and_state(F64, "cpu")
    grid = make_function_space(model.domain, F64, "cpu")
    st = imex.TRBDF2Soil(model=model, grid=grid, iters=3, tridiag="thomas")
    rhs = make_rhs(model, grid)
    t, dt = torch.tensor(0.0, dtype=F64), torch.tensor(120.0, dtype=F64)
    for _ in range(gct.N_STEPS // 4):
        Y = st.step(rhs, Y, Ya, t, dt)
        t = t + dt
    assert float(t) == float(golden["t"])
    _assert_tree_close(state_to_numpy(Y)["soil"], {k: golden[k] for k in ("vartheta_l", "theta_i", "rho_e_int")})


def test_stages_count_rhs_evaluations():
    """The values of tests/soil/test_imex.py: 1 + 2 stages x iters x active
    components (the rate freeze-thaw fixed point counts as one)."""
    model, *_ = gct.build_model_and_state(F64, "cpu")
    grid = make_function_space(model.domain, F64, "cpu")
    assert imex.TRBDF2Soil(model=model, grid=grid, iters=3).stages == 1 + 2 * 3 * 2
    assert imex.TRBDF2Soil(model=model, grid=grid, iters=2).stages == 1 + 2 * 2 * 2
    water_only = model_from_reference(bench.build_stiff(4, 2, jnp.float64)[0], device="cpu")
    assert imex.TRBDF2Soil(model=water_only, grid=grid, iters=3).stages == 1 + 2 * 3
    freeze = dataclasses.replace(model, freeze_thaw=ft.FreezeThaw(tau=60.0))
    assert imex.TRBDF2Soil(model=freeze, grid=grid, iters=2).stages == 1 + 2 * 2 * 3
    equilibrium = dataclasses.replace(model, freeze_thaw=ft.EquilibriumFreezeThaw())
    assert imex.TRBDF2Soil(model=equilibrium, grid=grid, iters=2).stages == 1 + 2 * 2 * 2
    assert imex.BackwardEulerRichards(model=model, grid=grid, iters=3).stages == 3
    for cls in imex.IMPLICIT_STEPPERS:
        st = cls(model=model, grid=grid)
        assert st.unconditionally_stable and st.order == (2 if cls is imex.TRBDF2Soil else 1)


def test_stage_times_are_the_evaluation_times():
    """A recording BC callable sees, per step, exactly the times
    ``stage_times`` names: TR-BDF2 t, t + g dt, t + dt; backward Euler
    t + dt."""
    model, Y, Ya, _ = gct.build_model_and_state(F64, "cpu")
    seen = []
    top = dataclasses.replace(model.boundary_conditions.top,
                              hydrology=sw_dirichlet_recording(seen, 0.31))
    model = dataclasses.replace(model, boundary_conditions=dataclasses.replace(model.boundary_conditions, top=top))
    grid = make_function_space(model.domain, F64, "cpu")
    t, dt = torch.tensor(7.5, dtype=F64), torch.tensor(120.0, dtype=F64)
    for cls in imex.IMPLICIT_STEPPERS:
        seen.clear()
        st = cls(model=model, grid=grid, iters=2)
        st.step(make_rhs(model, grid), Y, Ya, t, dt)
        assert sorted(set(seen)) == sorted(float(x) for x in st.stage_times(t, dt)), cls.__name__
    g = 2.0 - math.sqrt(2.0)
    assert [float(x) for x in imex.TRBDF2Soil(model, grid).stage_times(t, dt)] == [7.5, 7.5 + g * 120.0, 127.5]


def sw_dirichlet_recording(log, value):
    from landhydrology_tpu_torch import Dirichlet

    def v(t):
        log.append(float(t))
        return value

    return Dirichlet(v)


def test_stepper_from_reference():
    """A JAX TRBDF2Soil(iters=3, tridiag="pcr") becomes the port's, with the
    grid rebuilt on the model's device; both give the same step on golden
    #1."""
    jm, Y, Ya, _ = gc.build_model_and_state(jnp.float64)
    jgrid = jax_grid(jm.domain, jnp.float64)
    jst = jimex.TRBDF2Soil(model=jm, grid=jgrid, iters=3, tridiag="pcr")
    model, Yt, Yat = _port(jm, _np(Y), _np(Ya))
    assert torch.device(model.device).type == "cpu"
    st = stepper_from_reference(jst, model)
    assert type(st) is imex.TRBDF2Soil and (st.iters, st.tridiag) == (3, "pcr") and st.model is model
    assert st.grid.zc.device.type == "cpu" and st.grid.dz == float(jgrid.dz)
    want = jst.step(jax_make_rhs(jm, jgrid), Y, Ya, jnp.asarray(5.0), jnp.asarray(120.0))
    got = st.step(make_rhs(model, st.grid), Yt, Yat, torch.tensor(5.0, dtype=F64), torch.tensor(120.0, dtype=F64))
    _assert_tree_close(state_to_numpy(got)["soil"], _np(want)["soil"])
    with pytest.raises(NotImplementedError, match="SSPRK33"):
        from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33

        stepper_from_reference(JSSPRK33(), model)
