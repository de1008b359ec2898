"""Gradients through the PyTorch port's eager engine (ROADMAP A17) against
the JAX package.

- the analogues of ``tests/test_differentiability.py``'s first two tests:
  d(moisture)/dKsat through 200 SSPRK33 steps against central finite
  differences (rtol 2e-4) and positive; the gradient in a uniform start
  moisture negative;
- the eager sweep: ``stepper.step`` loops under ``torch.autograd`` against
  ``jax.jit(jax.grad(...))`` of the same loops under ``lax.scan``, frozen in
  ``golden_grad_f64.npz`` by ``make_golden_grad.py`` (its compile takes a
  minute or more per implicit case), f64, every field's gradient within
  1e-10 of that gradient's largest magnitude, and the gradients in t0 and
  dt: golden #1 under SSPRK33, TR-BDF2 (Thomas and PCR), BackwardEulerSoil,
  BackwardEulerRichards and ``assume_no_ice``; the freeze golden with rate
  and equilibrium freeze-thaw, each with and without lagged coefficients;
  the heat-only and water-only branches; per-column BC kinds; a
  ``VariableDepthColumn``; and a LandModel pond forced by rain rows;
- the MOST top face: the land golden's soil alone (SSPRK33, lagged
  coefficients, TR-BDF2) and its LandModel (without routing), whose
  gradient is the derivative of the MOST root (``surface_fluxes.py``,
  ``_with_root_derivative``), against the JAX package's forward
  differenced along seeded directions and in dt (frozen by
  ``make_golden_grad.py``, keys ``most__``), rtol 1e-7; and, a second
  witness, against central differences of the port's own forward.
  ``jax.grad`` there differentiates the solve's last false-position step on
  a bracket one ulp wide, and misses the differences of the JAX package's
  own forward by up to a factor of 20 on d(1/L)/dT, so the port is held to
  the differences there.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu_torch import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    initialize_states,
)
from landhydrology_tpu_torch.constants import default_earth_param_set as ps
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, stepper_from_reference
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models import land
from landhydrology_tpu_torch.models.soil import surface_fluxes as sf
from landhydrology_tpu_torch.models.soil import vanGenuchten
from landhydrology_tpu_torch.models.soil.freeze_thaw import wrap_stepper_with_projection
from landhydrology_tpu_torch.models.soil.lagged import wrap_stepper_for_soil
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.runtime import make_forced_segment_run
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config_torch as gct
from tests.data import make_golden_grad as mg

F64 = torch.float64
GOLDEN = "tests/data/golden_grad_f64.npz"
NZ, NSTEP, DT = 40, 200, 0.5


def _t(x):
    return torch.tensor(x, dtype=F64)


def _infiltration(ksat, theta0=0.1, n=3.0, alpha=2.7, theta_r=0.05):
    """``test_differentiability.py``'s column: a Dirichlet top over free
    drainage, start moisture ``theta0``."""
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=n, alpha=alpha, Ksat=ksat,
                                                                        theta_r=theta_r)),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.25)),
                                         bottom=SoilComponentBC(hydrology=FreeDrainage())),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3), device="cpu",
    )
    Y, Ya = initialize_states(model, lambda z, m: {
        "vartheta_l": torch.zeros_like(z) + theta0, "theta_i": torch.zeros_like(z)}, 0.0)
    return model, Y, Ya


def _steps(model, Y, Ya, n, dt=DT):
    rhs = make_rhs(model, make_function_space(model.domain, F64, "cpu"))
    t, dt = _t(0.0), _t(dt)
    for _ in range(n):
        Y = SSPRK33().step(rhs, Y, Ya, t, dt)
        t = t + dt
    return Y


def _final_moisture(ksat):
    model, Y, Ya = _infiltration(ksat)
    return torch.sum(_steps(model, Y, Ya, NSTEP)["soil"]["vartheta_l"]) / NZ


def test_grad_through_simulation_matches_finite_difference():
    """``test_differentiability.py:60``: d/dKsat of the depth-integrated
    moisture after 200 steps, AD against central differences, rtol 2e-4."""
    ksat = torch.tensor(1e-5, dtype=F64, requires_grad=True)
    (grad,) = torch.autograd.grad(_final_moisture(ksat), ksat)
    grad = float(grad)
    assert np.isfinite(grad) and grad > 0  # more conductive soil wets faster
    eps = 1e-8
    with torch.no_grad():
        fd = (float(_final_moisture(_t(1e-5 + eps))) - float(_final_moisture(_t(1e-5 - eps)))) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=2e-4)


def test_grad_wrt_initial_state():
    """``test_differentiability.py:76``: the adjoint in a uniform start
    moisture after 50 steps is negative (a wetter start moves the profile
    toward the 0.2 target)."""
    theta0 = torch.tensor(0.12, dtype=F64, requires_grad=True)
    model, Y, Ya = _infiltration(1e-5, theta0, n=2.0, alpha=2.6, theta_r=0.0)
    loss = torch.mean((_steps(model, Y, Ya, 50)["soil"]["vartheta_l"] - 0.2) ** 2)
    (g,) = torch.autograd.grad(loss, theta0)
    assert np.isfinite(float(g)) and float(g) < 0


# ---- the eager sweep against the frozen jax.grad ----


def _port_case(name):
    """The port's model, state, auxiliary state, wrapped stepper, steps, dt
    and rows of sweep case ``name``."""
    jm, Y, Ya, jst, steps, dt, rows = mg.sweep_case(name)
    model = model_from_reference(jm, device="cpu")
    st = SSPRK33() if type(jst).__name__ == "SSPRK33" else stepper_from_reference(jst, model, device="cpu")
    return model, state_from_numpy(Y, device="cpu"), state_from_numpy(Ya, device="cpu"), st, steps, dt, rows


def _sweep_loss(name, Y0, t0, dt):
    model, _, Ya, st, steps, _, rows = _port_case(name)
    if rows is not None:
        seg = make_forced_segment_run(model, st, dt=float(dt), field_names=tuple(rows), engine="torch")
        Yf, _ = seg(Y0, Ya, t0, {k: torch.as_tensor(v, dtype=F64) for k, v in rows.items()})
    else:
        soil = model
        st = wrap_stepper_for_soil(wrap_stepper_with_projection(st, soil), soil)
        rhs = make_rhs(model, make_function_space(model.domain, F64, "cpu"))
        Yf, t = Y0, t0
        for _ in range(steps):
            Yf = st.step(rhs, Yf, Ya, t, dt)
            t = t + dt
    W = gct.sweep_weights({g: {k: v.detach().numpy() for k, v in f.items()} for g, f in Y0.items()})
    return sum(torch.sum(torch.as_tensor(W[g][k]) * Yf[g][k]) for g in Yf for k in Yf[g])


def _assert_grad(got, ref, what, rtol=1e-10):
    scale = float(np.max(np.abs(ref))) or 1.0
    dev = float(np.max(np.abs(np.asarray(got) - ref)))
    assert dev <= rtol * scale, f"{what}: |AD - JAX| = {dev:.3e} > {rtol:g} x {scale:.3e}"


@pytest.mark.parametrize("name", list(mg.SWEEP))
def test_eager_gradient_matches_jax(name):
    """The eager loop's gradient in every start field, t0 and dt against
    the frozen ``jax.jit(jax.grad(...))``, rtol 1e-10 of each gradient's
    scale; the loss at rtol 1e-12."""
    golden = np.load(GOLDEN)
    _, Y, _, _, _, dt, rows = _port_case(name)
    leaves = {g: {k: v.clone().requires_grad_(True) for k, v in f.items()} for g, f in Y.items()}
    t0 = _t(0.0).requires_grad_(True)
    dt_t = _t(dt).requires_grad_(rows is None)
    loss = _sweep_loss(name, leaves, t0, dt_t)
    np.testing.assert_allclose(float(loss), float(golden[f"sweep__{name}__loss"]), rtol=1e-12)
    keys = [(g, k) for g in leaves for k in leaves[g]]
    inputs = [leaves[g][k] for g, k in keys] + [t0] + ([dt_t] if rows is None else [])
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros(()) if d is None else d for d in grads]
    for (g, k), d in zip(keys, grads):
        _assert_grad(d.numpy(), golden[f"sweep__{name}__g_{g}__{k}"], f"{name} d/d{g}.{k}")
    _assert_grad(grads[len(keys)].numpy(), golden[f"sweep__{name}__g_t0"], f"{name} d/dt0")
    if rows is None:
        _assert_grad(grads[len(keys) + 1].numpy(), golden[f"sweep__{name}__g_dt"], f"{name} d/ddt")
        assert float(golden[f"sweep__{name}__g_dt"]) != 0.0


def test_sweep_covers_the_cases_and_nonzero_t0():
    """The sweep holds every case named in the module docstring, and its
    time-dependent BC gives t0 a gradient that is not zero."""
    golden = np.load(GOLDEN)
    assert set(mg.SWEEP) <= {k.split("__")[1] for k in golden.files if k.startswith("sweep__")}
    assert float(golden["sweep__kinds__g_t0"]) != 0.0


# ---- the MOST top face against finite differences ----


def _directional_fd(loss_of, Y, g, n_dirs=3, rel_eps=1e-5, seed=0):
    """``[(AD, FD)]`` along ``n_dirs`` random directions scaled per field,
    by central differences of step ``rel_eps`` of each field's scale.  The
    directions leave theta_i alone: at theta_i = 0 the closures switch
    branches (the Kersten number's frozen form), a kink with no
    derivative."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_dirs):
        d = {grp: {k: torch.as_tensor(rng.standard_normal(tuple(v.shape))) * (float(v.abs().max()) or 1.0)
                   * (k != "theta_i") for k, v in f.items()} for grp, f in Y.items()}
        ad = sum(float(torch.sum(g[grp][k] * d[grp][k])) for grp in d for k in d[grp])
        with torch.no_grad():
            plus = {grp: {k: v + rel_eps * d[grp][k] for k, v in f.items()} for grp, f in Y.items()}
            minus = {grp: {k: v - rel_eps * d[grp][k] for k, v in f.items()} for grp, f in Y.items()}
            fd = (float(loss_of(plus)) - float(loss_of(minus))) / (2 * rel_eps)
        out.append((ad, fd))
    return out


@pytest.mark.parametrize("case", ["most_soil", "land"])
def test_most_gradient_matches_finite_differences(case):
    """The land golden's soil alone (MOST top) and its LandModel (MOST,
    rain, pond) without the kinematic-wave routing, whose Manning flux
    sqrt(|slope|) has no derivative at the golden's level pond, 4 SSPRK33
    steps of dt=2: AD along three random directions equals central
    differences at rtol 1e-7 (the derivative of the solve's operations,
    before the root derivative, missed them by 2.4e-5 to 4.3e-4)."""
    model, Y, Ya, dt = gct.build_land_model_and_state(F64, "cpu")
    if case == "most_soil":
        model, Y = model.soil, {"soil": Y["soil"]}
        Ya = {k: v for k, v in Ya.items() if k != "surface"}
        rhs = make_rhs(model, make_function_space(model.domain, F64, "cpu"))
    else:
        model = dataclasses.replace(model, surface=dataclasses.replace(model.surface, runoff=None))
        rhs = land.make_rhs(model)
    W = gct.sweep_weights({g: {k: v.numpy() for k, v in f.items()} for g, f in Y.items()})

    def loss_of(Y0):
        Yc, t = Y0, _t(0.0)
        for _ in range(4):
            Yc = SSPRK33().step(rhs, Yc, Ya, t, _t(dt))
            t = t + dt
        return sum(torch.sum(torch.as_tensor(W[g][k]) * Yc[g][k]) for g in Yc for k in Yc[g])

    leaves = {g: {k: v.clone().requires_grad_(True) for k, v in f.items()} for g, f in Y.items()}
    keys = [(g, k) for g in leaves for k in leaves[g]]
    grads = torch.autograd.grad(loss_of(leaves), [leaves[g][k] for g, k in keys])
    g = {grp: {} for grp in leaves}
    for (grp, k), d in zip(keys, grads):
        g[grp][k] = d
    for ad, fd in _directional_fd(loss_of, Y, g):
        np.testing.assert_allclose(ad, fd, rtol=1e-7)


def _most_loss(model, Ya, stepper, case, W):
    """``loss(Y0, dt)`` of a MOST case: the sweep's weighted sum of the
    state after the case's eager steps from t0 = 0."""
    if case["model"] == "land":
        rhs = land.make_rhs(model)
    else:
        rhs = make_rhs(model, make_function_space(model.domain, F64, "cpu"))
        stepper = wrap_stepper_for_soil(wrap_stepper_with_projection(stepper, model), model)

    def loss(Y0, dt):
        Yc, t = Y0, _t(0.0)
        for _ in range(case["steps"]):
            Yc = stepper.step(rhs, Yc, Ya, t, dt)
            t = t + dt
        return sum(torch.sum(torch.as_tensor(W[g][k]) * Yc[g][k]) for g in Yc for k in Yc[g])

    return loss


@pytest.mark.parametrize("case", list(gct.MOST_CASES))
def test_most_gradient_matches_jax_differences(case):
    """The land golden's soil alone (MOST top; SSPRK33, lagged coefficients,
    TR-BDF2) and its LandModel without routing: the eager loop's loss equals
    the JAX package's (rtol 1e-12), and its AD along the golden's three
    directions and in dt equals the fourth-order central differences of
    the JAX package's forward (``most__``), rtol 1e-7."""
    golden = np.load(GOLDEN)
    model, Y, Ya, stepper, spec = gct.build_most_case(case, F64, "cpu")
    W = gct.sweep_weights({g: {k: v.numpy() for k, v in f.items()} for g, f in Y.items()})
    loss_of = _most_loss(model, Ya, stepper, spec, W)
    leaves = {g: {k: v.clone().requires_grad_(True) for k, v in f.items()} for g, f in Y.items()}
    dt = _t(spec["dt"]).requires_grad_(True)
    loss = loss_of(leaves, dt)
    np.testing.assert_allclose(float(loss), float(golden[f"most__{case}__loss"]), rtol=1e-12)
    keys = [(g, k) for g in leaves for k in leaves[g]]
    grads = torch.autograd.grad(loss, [leaves[g][k] for g, k in keys] + [dt])
    dirs = gct.most_fd_directions(golden, case)
    ad = [sum(float(torch.sum(d * torch.as_tensor(dr[g][k]))) for (g, k), d in zip(keys, grads)) for dr in dirs]
    np.testing.assert_allclose(ad, golden[f"most__{case}__fd"], rtol=1e-7)
    np.testing.assert_allclose(float(grads[-1]), float(golden[f"most__{case}__fd_dt"]), rtol=1e-7)


def test_most_solve_derivative_matches_jax_differences():
    """``surface_conditions``: d(1/L)/dT and du*/dT by autograd at the
    golden's 32 surface temperatures equal the fourth-order central
    differences of the JAX package's solve (``most__surface__``), rtol
    1e-7 (atol 1e-12, where u* does not move)."""
    golden = np.load(GOLDEN)
    T = torch.tensor(golden["most__surface__T"], requires_grad=True)
    r = sf.surface_conditions(ps, 2.0, 300.0, 0.005, 0.0 * T, T, 0.004 + 0.0 * T, 2.0, 0.01, 0.001, 300.0)
    g_L = torch.autograd.grad((1.0 / r["L_mo"]).sum(), T, retain_graph=True)[0].numpy()
    g_u = torch.autograd.grad(r["x_star"][0].sum(), T)[0].numpy()
    np.testing.assert_allclose(g_L, golden["most__surface__fd_Linv"], rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(g_u, golden["most__surface__fd_ustar"], rtol=1e-7, atol=1e-12)


def test_most_solve_derivative_is_the_root_derivative():
    """``surface_conditions``: d(1/L)/dT and du*/dT by autograd equal
    central differences of the forward (rtol 1e-6) over both Businger
    branches; the forward is unchanged by the derivative."""
    rng = np.random.default_rng(0)
    T = 285.0 + 30.0 * rng.random(32)

    def solve(T_):
        r = sf.surface_conditions(ps, 2.0, 300.0, 0.005, 0.0 * T_, T_, 0.004 + 0.0 * T_, 2.0, 0.01, 0.001,
                                   300.0)
        return 1.0 / r["L_mo"], r["x_star"][0]

    Tt = torch.tensor(T, requires_grad=True)
    Linv, u_star = solve(Tt)
    g_L = torch.autograd.grad(Linv.sum(), Tt, retain_graph=True)[0].numpy()
    g_u = torch.autograd.grad(u_star.sum(), Tt)[0].numpy()
    with torch.no_grad():
        plain = solve(torch.tensor(T))
        np.testing.assert_array_equal(plain[0].numpy(), Linv.detach().numpy())
        eps = 1e-4
        up, down = solve(torch.tensor(T + eps)), solve(torch.tensor(T - eps))
    fd_L = ((up[0] - down[0]) / (2 * eps)).numpy()
    fd_u = ((up[1] - down[1]) / (2 * eps)).numpy()
    np.testing.assert_allclose(g_L, fd_L, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(g_u, fd_u, rtol=1e-6, atol=1e-12)
    assert (T < 300.0).any() and (T > 300.0).any()  # both branches: stable and unstable


def test_tie_semantics_split_the_gradient_as_jax():
    """``water._maximum`` / ``_minimum`` / ``_clip`` give ``torch.clamp``'s
    values and ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip``'s gradient:
    half to each operand at a tie."""
    from landhydrology_tpu_torch.models.soil import water as sw

    x = torch.tensor([0.0, 1.0, -1.0, 0.5], dtype=F64, requires_grad=True)
    for fn, ref, jfn in ((lambda v: sw._maximum(v, 0.0), lambda v: torch.clamp(v, min=0.0),
                          lambda v: jnp.maximum(v, 0.0)),
                         (lambda v: sw._minimum(v, 0.5), lambda v: torch.clamp(v, max=0.5),
                          lambda v: jnp.minimum(v, 0.5)),
                         (lambda v: sw._clip(v, 0.0, 1.0), lambda v: torch.clamp(v, 0.0, 1.0),
                          lambda v: jnp.clip(v, 0.0, 1.0))):
        y = fn(x)
        np.testing.assert_array_equal(y.detach().numpy(), ref(x).detach().numpy())
        (g,) = torch.autograd.grad(y.sum(), x)
        jg = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x.detach().numpy())))
        np.testing.assert_array_equal(g.numpy(), jg)
