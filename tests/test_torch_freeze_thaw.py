"""Freeze-thaw in the PyTorch port (``models/soil/freeze_thaw.py``) and the
column kernel's B3 modes.

The same inputs, drawn with numpy from a seed, go through the JAX package and
the port in float64:

- the closures (``phase_change_sources``, ``equilibrium_unfrozen_liquid``,
  ``equilibrium_phase_projection``) on cells on both sides of T_0, rtol 1e-13;
- the coupled rhs with rate sources on an icy state, rtol 1e-13 of each
  field's largest tendency (as ``test_torch_rhs.py``);
- the eager run of the freeze golden against ``golden_freeze_f64.npz``,
  rtol 1e-13 (the bar of ``test_golden_trajectories.py``);
- the fused run (its plain version on the CPU) against the JAX Pallas kernel
  in interpret mode, rtol 1e-12, for the rate and equilibrium schemes, with
  and without lagged coefficients.

Tests marked ``cuda`` launch the CUDA kernel and skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedHydrologyModel as JPrescribedHydrologyModel
from landhydrology_tpu import PrescribedTemperatureModel as JPrescribedTemperatureModel
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil import freeze_thaw as jft
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import PrescribedHydrologyModel, PrescribedTemperatureModel, Simulation
from landhydrology_tpu_torch.constants import default_earth_param_set as ps
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.soil import freeze_thaw as ft
from landhydrology_tpu_torch.models.soil import vanGenuchten
from landhydrology_tpu_torch.models.soil.lagged import LaggedCoefficientStepper
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct

GOLDEN_FREEZE = "tests/data/golden_freeze_f64.npz"
FIELDS = ("vartheta_l", "theta_i", "rho_e_int")
NZ, NCOL = 16, 4  # the freeze golden's column


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _hms(per_column, n):
    """(JAX, port) van Genuchten models with the same parameters."""
    if not per_column:
        kw = dict(n=2.0, alpha=2.6, Ksat=1e-7, theta_r=0.05)
        return JvanGenuchten(**kw), vanGenuchten(**kw)
    rng = np.random.default_rng(1)
    kw = dict(n=rng.uniform(1.5, 3.0, n), alpha=rng.uniform(1.5, 4.0, n),
              Ksat=rng.uniform(1e-7, 1e-5, n), theta_r=rng.uniform(0.0, 0.05, n))
    return (JvanGenuchten(**{k: jnp.asarray(v) for k, v in kw.items()}),
            vanGenuchten(**{k: _t(v) for k, v in kw.items()}))


def _cells(seed, shape=(64, 8)):
    """theta_l, theta_i, T (255-290 K, on both sides of T_0), rho_c_s."""
    rng = np.random.default_rng(seed)
    theta_l = rng.uniform(0.06, 0.4, shape)
    theta_i = rng.uniform(0.0, 0.1, shape) * (rng.random(shape) < 0.6)
    T = rng.uniform(255.0, 290.0, shape)
    T[0, :] = ps.T_0  # exactly at the freezing point
    T[1, :] = 150.0  # under the Clapeyron guard of 200 K
    rho_c_s = rng.uniform(1.5e6, 3.0e6, shape)
    return theta_l, theta_i, T, rho_c_s


def _close(got, ref, rtol=1e-13, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("per_column", [False, True], ids=["scalar", "per_column"])
def test_equilibrium_unfrozen_liquid_matches_jax(per_column):
    """theta_l_max(T): finite below T_0, +inf at and above it; rtol 1e-13."""
    _, _, T, _ = _cells(2)
    jhm, hm = _hms(per_column, T.shape[1])
    ref = np.asarray(jft.equilibrium_unfrozen_liquid(jhm, jnp.asarray(T), 0.4, jps))
    got = ft.equilibrium_unfrozen_liquid(hm, _t(T), 0.4, ps).numpy()
    assert np.array_equal(np.isinf(got), T >= ps.T_0) and np.array_equal(np.isinf(ref), np.isinf(got))
    finite = np.isfinite(ref)
    _close(got[finite], ref[finite])


@pytest.mark.parametrize("per_column", [False, True], ids=["scalar", "per_column"])
def test_phase_change_sources_match_jax(per_column):
    """The (d vartheta_l/dt, d theta_i/dt) pair on cells that freeze, melt
    and stay put; rtol 1e-13, atol 1e-13 of the largest rate (entries at the
    kinks of the min/max are differences of nearly equal terms)."""
    theta_l, theta_i, T, rho_c_s = _cells(3)
    jhm, hm = _hms(per_column, T.shape[1])
    nu = np.random.default_rng(4).uniform(0.42, 0.5, T.shape[1])
    ref = jft.phase_change_sources(
        jft.FreezeThaw(tau=60.0), jhm, *(jnp.asarray(x) for x in (theta_l, theta_i, T)),
        jnp.asarray(nu), jnp.asarray(rho_c_s), jps,
    )
    got = ft.phase_change_sources(
        ft.FreezeThaw(tau=60.0), hm, *(_t(x) for x in (theta_l, theta_i, T)), _t(nu), _t(rho_c_s), ps
    )
    for g, r in zip(got, ref):
        r = np.asarray(r)
        _close(g.numpy(), r, atol=1e-13 * np.max(np.abs(r)))
    d_l, d_i = (g.numpy() for g in got)
    assert (d_i > 0).any() and (d_i < 0).any()  # both freezing and melting
    np.testing.assert_allclose(d_l + (ps.rho_cloud_ice / ps.rho_cloud_liq) * d_i, 0.0, atol=1e-18)


def _freeze_models(scheme, **kw):
    """(JAX model, port model) of the freeze golden's column with ``scheme``."""
    jm = gc.build_freeze_model_and_state(jnp.float64)[0]
    jm = dataclasses.replace(jm, freeze_thaw=scheme, **kw)
    return jm, model_from_reference(jm, device="cpu")


def test_equilibrium_phase_projection_matches_jax():
    """The bisection lands on the same partition: rtol 1e-13 on vartheta_l
    and theta_i, rho_e_int untouched, water mass conserved."""
    theta_l, theta_i, T, rho_c_s = _cells(5, shape=(NZ, NCOL))
    e = rho_c_s * (T - ps.T_0) - theta_i * ps.rho_cloud_ice * ps.LH_f0
    jm, pm = _freeze_models(jft.EquilibriumFreezeThaw())
    Y = {"soil": {"vartheta_l": theta_l, "theta_i": theta_i, "rho_e_int": e}}
    ref = jft.equilibrium_phase_projection(jm, {"soil": {k: jnp.asarray(v) for k, v in Y["soil"].items()}})
    got = ft.equilibrium_phase_projection(pm, state_from_numpy(Y, device="cpu"))
    for k in FIELDS:
        _close(got["soil"][k].numpy(), ref["soil"][k], atol=1e-16)
    assert np.array_equal(got["soil"]["rho_e_int"].numpy(), e)
    r = ps.rho_cloud_ice / ps.rho_cloud_liq
    mass = got["soil"]["vartheta_l"].numpy() + r * got["soil"]["theta_i"].numpy()
    np.testing.assert_allclose(mass, theta_l + r * theta_i, rtol=1e-14)
    assert (got["soil"]["theta_i"].numpy() > 1e-3).any() and (got["soil"]["theta_i"].numpy() == 0).any()


def _icy_freeze_state(seed=11):
    """A numpy state of the freeze golden's column with cells on both sides
    of T_0, some with ice."""
    rng = np.random.default_rng(seed)
    theta = 0.25 + 0.1 * rng.random((NZ, NCOL))
    theta_i = 0.05 * rng.random((NZ, NCOL))
    theta_i[:, 0] = 0.0
    T = 268.0 + 10.0 * rng.random((NZ, NCOL))
    rho_c_s = 1.3e6 + np.minimum(theta, 0.4 - theta_i) * ps.rho_cp_l + theta_i * ps.rho_cp_i
    e = rho_c_s * (T - ps.T_0) - theta_i * ps.rho_cloud_ice * ps.LH_f0
    return {"soil": {"vartheta_l": theta, "theta_i": theta_i, "rho_e_int": e}}


def test_rhs_rate_sources_match_jax():
    """The coupled rhs with FreezeThaw sources: theta_i gets a real
    tendency; rtol 1e-13 of each field's largest tendency."""
    jm, pm = _freeze_models(jft.FreezeThaw(tau=60.0))
    Y = _icy_freeze_state()
    zc = make_function_space(pm.domain, torch.float64, "cpu").zc
    ref = jax_make_rhs(jm)({"soil": {k: jnp.asarray(v) for k, v in Y["soil"].items()}},
                           {"zc": jnp.asarray(zc.numpy()), "soil": {}}, jnp.asarray(3.0))
    got = make_rhs(pm)(state_from_numpy(Y, device="cpu"), {"zc": zc, "soil": {}}, torch.tensor(3.0, dtype=torch.float64))
    for k in FIELDS:
        r = np.asarray(ref["soil"][k])
        scale = float(np.max(np.abs(r)))
        assert scale > 0, k
        _close(got["soil"][k].numpy(), r, atol=1e-13 * scale)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_eager_freeze_run_matches_golden(engine):
    """64 steps of the rate-based freeze golden reproduce
    golden_freeze_f64.npz at rtol 1e-13 on both engines (the fused one takes
    its plain version on the CPU); ice forms."""
    model, Y, Ya, dt = gct.build_freeze_model_and_state(torch.float64, "cpu")
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt,
                     tspan=(0.0, gct.FREEZE_STEPS * dt), engine=engine, steps_per_call=16)
    sim.run()
    golden = np.load(GOLDEN_FREEZE)
    final = state_to_numpy(sim.Y)["soil"]
    assert float(np.max(final["theta_i"])) > 1e-4
    for k in FIELDS:
        np.testing.assert_allclose(final[k], golden[k], rtol=1e-13, atol=1e-18, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_freeze_config_torch_reproduces_jax_config(dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jm, Y, Ya, dt = gc.build_freeze_model_and_state(jdtype)
    model, Yt, Yat, dtt = gct.build_freeze_model_and_state(dtype, "cpu")
    assert dt == dtt == gct.FREEZE_DT and gct.FREEZE_STEPS == gc.FREEZE_STEPS
    for k in FIELDS:
        assert Yt["soil"][k].dtype == dtype
        np.testing.assert_array_equal(Yt["soil"][k].numpy(), np.asarray(Y["soil"][k]), err_msg=k)
    np.testing.assert_array_equal(Yat["zc"].numpy(), np.asarray(Ya["zc"]))
    ref = model_from_reference(jm, dtype=dtype, device="cpu")
    for f in ("domain", "soil_param_set", "hydrology_model", "energy_model", "freeze_thaw",
              "earth_param_set", "dtype", "assume_no_ice", "coefficient_update"):
        assert getattr(model, f) == getattr(ref, f), f


SCHEMES = {
    "rate": (jft.FreezeThaw(tau=60.0), {}),
    "equilibrium": (jft.EquilibriumFreezeThaw(), {}),
    "lagged_rate": (jft.FreezeThaw(tau=60.0), {"coefficient_update": "step"}),
    "lagged_equilibrium": (jft.EquilibriumFreezeThaw(), {"coefficient_update": "step"}),
}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_plain_fused_run_matches_jax_fused_kernel(scheme):
    """The port's fused run (plain version on the CPU) == the JAX Pallas
    kernel in interpret mode, 8 steps from t0 = 30 on an icy state that
    crosses T_0; rtol 1e-12 (the Pallas kernel's bar)."""
    jscheme, kw = SCHEMES[scheme]
    jm, pm = _freeze_models(jscheme, **kw)
    Y = _icy_freeze_state()
    jY = {"soil": {k: jnp.asarray(v) for k, v in Y["soil"].items()}}
    ref = jax_fused(jm, JSSPRK33(), dt=5.0, steps_per_call=8, tile_cols=NCOL, interpret=True)(jY, 30.0)
    Yt = state_from_numpy(Y, device="cpu")
    run = ck.make_fused_column_run(pm, SSPRK33(), dt=5.0, steps_per_call=8)
    assert ck.mode_name(run.mode) == {"rate": "B3-rate", "equilibrium": "B3-eq",
                                      "lagged_rate": "B2+B3-rate", "lagged_equilibrium": "B2+B3-eq"}[scheme]
    run(Yt, 30.0)
    got = state_to_numpy(Yt)["soil"]
    for k in FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(ref["soil"][k]), rtol=1e-12, atol=1e-16, err_msg=k)
    assert np.max(np.abs(got["theta_i"] - Y["soil"]["theta_i"])) > 1e-4  # the phase changed


def test_model_validation():
    model = gct.build_freeze_model_and_state(torch.float64, "cpu")[0]
    with pytest.raises(ValueError, match="assume_no_ice"):
        dataclasses.replace(model, assume_no_ice=True)
    with pytest.raises(TypeError, match="SoilEnergyModel"):
        dataclasses.replace(model, energy_model=PrescribedTemperatureModel())
    with pytest.raises(TypeError, match="SoilHydrologyModel"):
        dataclasses.replace(model, hydrology_model=PrescribedHydrologyModel())
    with pytest.raises(TypeError, match="FreezeThaw"):
        dataclasses.replace(model, freeze_thaw=object())
    # the reference refuses the same configurations
    jm = gc.build_freeze_model_and_state(jnp.float64)[0]
    with pytest.raises(ValueError, match="assume_no_ice"):
        dataclasses.replace(jm, assume_no_ice=True)
    with pytest.raises(TypeError, match="SoilEnergyModel"):
        dataclasses.replace(jm, energy_model=JPrescribedTemperatureModel())
    with pytest.raises(TypeError, match="SoilHydrologyModel"):
        dataclasses.replace(jm, hydrology_model=JPrescribedHydrologyModel())


def test_convert_carries_the_schemes():
    for scheme, cls in ((jft.FreezeThaw(tau=75.0), ft.FreezeThaw),
                        (jft.EquilibriumFreezeThaw(n_iter=40, T_lo=160.0, T_hi=330.0), ft.EquilibriumFreezeThaw)):
        _, pm = _freeze_models(scheme)
        assert type(pm.freeze_thaw) is cls
        assert dataclasses.asdict(pm.freeze_thaw) == dataclasses.asdict(scheme)


def test_simulation_and_fused_run_wrap_the_projection():
    """Simulation wraps the projection inside the lagged policy; the fused
    factory takes that wrapped stepper and refuses a projection the model
    does not call for."""
    eq_lagged = dataclasses.replace(
        gct.build_freeze_model_and_state(torch.float64, "cpu", freeze_thaw=ft.EquilibriumFreezeThaw())[0],
        coefficient_update="step",
    )
    Y, Ya = gct.build_freeze_model_and_state(torch.float64, "cpu")[1:3]
    sim = Simulation(eq_lagged, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=5.0, tspan=(0.0, 10.0), engine="fused")
    st = sim.stepper
    assert isinstance(st, LaggedCoefficientStepper) and isinstance(st.inner, ft.PhaseEquilibriumStepper)
    assert type(st.inner.inner) is SSPRK33
    assert ck.mode_name(sim._fused(1).mode) == "B2+B3-eq"
    rate = gct.build_freeze_model_and_state(torch.float64, "cpu")[0]
    with pytest.raises(ValueError, match="PhaseEquilibriumStepper"):
        ck.make_fused_column_run(rate, ft.PhaseEquilibriumStepper(inner=SSPRK33(), model=rate))


def test_kernel_args_pack_the_freeze_schemes():
    for scheme, mode in ((ft.FreezeThaw(tau=60.0), ck.MODE_FREEZE_RATE),
                         (ft.EquilibriumFreezeThaw(n_iter=40, T_lo=160.0, T_hi=330.0), ck.MODE_FREEZE_EQ)):
        model, Y, _, dt = gct.build_freeze_model_and_state(torch.float64, "cpu", freeze_thaw=scheme)
        run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=2)
        fields = [Y["soil"][k] for k in FIELDS]
        params, zc, dz, tables = run._inputs(NCOL, torch.device("cpu"))[:4]
        a = ck.kernel_args(model, fields, torch.empty(1, dtype=torch.float64), zc, dz, params, tables, 2, dt)
        assert a.mode == mode and ck.scratch_fields(mode) == 6
        tau = dict(zip(ck.PARAM_NAMES, params))["tau"]
        assert float(tau[0]) == (60.0 if mode == ck.MODE_FREEZE_RATE else 1.0) and tau[1] == 0
        if mode == ck.MODE_FREEZE_EQ:
            assert (a.n_iter, a.T_lo, a.T_hi) == (40, 160.0, 330.0)
    assert ck.scratch_fields(ck.MODE_LAGGED | ck.MODE_FREEZE_RATE) == 11


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["rate", "equilibrium"])
def test_cuda_freeze_kernel_matches_golden_and_plain(cuda_device, scheme):
    """f64: the rate kernel reproduces golden_freeze_f64.npz; both schemes
    match the plain version on the card; rtol 1e-12."""
    freeze = ft.FreezeThaw(tau=60.0) if scheme == "rate" else ft.EquilibriumFreezeThaw()
    model, Y, _, dt = gct.build_freeze_model_and_state(torch.float64, cuda_device, freeze_thaw=freeze)
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), dt, gct.FREEZE_STEPS, Y, 0.0))["soil"]
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=gct.FREEZE_STEPS, tile_cols=32)
    ck.LAUNCHES.clear()
    run(Y, 0.0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {ck.mode_name(run.mode): 1}
    got = state_to_numpy(Y)["soil"]
    ref = np.load(GOLDEN_FREEZE) if scheme == "rate" else plain
    for k in FIELDS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-16, err_msg=k)
        np.testing.assert_allclose(got[k], plain[k], rtol=1e-12, atol=1e-16, err_msg=k)
