"""The PyTorch port's MOST surface fluxes (``models/soil/surface_fluxes.py``)
against the JAX package's.

- the Businger functions and both polynomial arctans on a grid of
  stability parameters, f64 rtol 1e-13;
- ``surface_conditions`` on the Brent oracle's grid of states
  (``tests/soil/test_most_oracle.py``, neutral and decoupling states
  included): stars, Obukhov length and residual, f64 rtol 1e-13; in f32
  against the JAX f32 solve at rtol 1e-5 on the stars; its ``probes``
  against a scalar replay of rounds that stop at their first sign change;
- both flux functions, the time-varying atmosphere, the refusals of
  ``test_prescribed_atmos_bc.py``, and the soil rhs with a MOST top, with
  stage and with lagged coefficients.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil import surface_fluxes as jsf
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch import (
    PrescribedAtmosForcing,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    VerticalFlux,
    boundary_fluxes,
)
from landhydrology_tpu_torch.constants import default_earth_param_set as ps
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.soil import surface_fluxes as sf
from landhydrology_tpu_torch.models.soil.lagged import make_coefficient_fns
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from tests.soil.test_most_oracle import _state_grid
from tests.soil.test_prescribed_atmos_bc import model as jax_atmos_model  # noqa: F401 (fixture)

ZETA = np.concatenate([-np.logspace(-6, 2.3, 40), [0.0], np.logspace(-6, 2.3, 40)])


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("name", ["psi_m", "psi_h", "arctan_kernel_safe"])
def test_businger_functions_match_jax(name):
    got = getattr(sf, name)(_t(ZETA)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jsf, name)(jnp.asarray(ZETA))), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("name", ["psi_m_diff", "psi_h_diff"])
def test_psi_differences_match_jax(name):
    zeta0 = ZETA * 0.0005  # zeta * z_0 / z_atm: same sign
    got = getattr(sf, name)(_t(ZETA), _t(zeta0)).numpy()
    ref = np.asarray(getattr(jsf, name)(jnp.asarray(ZETA), jnp.asarray(zeta0)))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-15)
    r = np.linspace(-0.75, 0.75, 31)
    np.testing.assert_allclose(sf._arctan_reduced(_t(r)).numpy(), np.asarray(jsf._arctan_reduced(jnp.asarray(r))),
                               rtol=1e-13, atol=1e-16)


def _grid_conditions(mod, dtype, theta_scale=290.0, q_atm=0.01):
    """``surface_conditions`` of ``mod`` (the JAX module or the port's)
    over the Brent oracle's state grid."""
    arr = np.asarray(_state_grid(), dtype=np.float64)
    n = len(arr)
    if mod is jsf:
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        a = lambda x: jnp.asarray(x, jd)  # noqa: E731
        param_set = jps
    else:
        a = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)  # noqa: E731
        param_set = ps
    cond = mod.surface_conditions(
        param_set, u_atm=a(arr[:, 0]), theta_atm=a(290.0 + arr[:, 1]), q_atm=a(np.full(n, q_atm)),
        u_sfc=a(np.zeros(n)), theta_sfc=a(np.full(n, 290.0)), q_sfc=a(q_atm - arr[:, 2]),
        z_atm=a(arr[:, 3]), z_0m=a(arr[:, 4]), z_0s=a(arr[:, 4]), theta_scale=a(np.full(n, theta_scale)),
    )
    out = {f"x_star{i}": np.asarray(x) for i, x in enumerate(cond["x_star"])}
    out.update(L_mo=np.asarray(cond["L_mo"]), residual=np.asarray(cond["residual"]))
    return arr, out


def test_surface_conditions_match_jax_on_the_oracle_grid_f64():
    arr, ref = _grid_conditions(jsf, torch.float64)
    _, got = _grid_conditions(sf, torch.float64)
    for k in ref:
        finite = np.isfinite(ref[k])
        np.testing.assert_array_equal(np.isfinite(got[k]), finite, err_msg=k)
        scale = 1e-13 * np.max(np.abs(ref[k][finite])) if k == "residual" else 1e-300
        np.testing.assert_allclose(got[k][finite], ref[k][finite], rtol=1e-13, atol=scale, err_msg=k)
    neutral = (arr[:, 1] == 0.0) & (arr[:, 2] == 0.0)
    assert neutral.any() and np.all(np.isinf(got["L_mo"][neutral]))  # c0 == 0: Linv = 0
    assert np.max(got["residual"]) > 1e-3  # the decoupling states are on the grid


def _early_stop_probes(state, q_atm=0.01, theta_scale=290.0, n_rounds=20):
    """The h evaluations of the multisection rounds for one oracle state
    when each round evaluates its probes in order and stops at the first
    one past the sign change, replayed in scalar float64."""
    u, d_theta, d_q, z, z0 = (float(x) for x in state)
    dth, dq = (290.0 + d_theta) - 290.0, q_atm - (q_atm - d_q)  # as the grid's inputs give them
    kappa, g, eps = ps.von_karman_const, ps.grav, ps.molmass_ratio - 1.0
    log_z = np.log(z / z0)
    c0 = kappa * kappa * g * ((1.0 + eps * q_atm) * dth + eps * theta_scale * dq) / theta_scale

    def h(Linv):
        L = _t([Linv])
        dm = max(float(log_z - sf.psi_m_diff(z * L, z0 * L)), 1e-3)
        ds = max(float(sf._PRANDTL_0 * (log_z - sf.psi_h_diff(z * L, z0 * L))), 1e-3)
        M = max(kappa * u, 1e-6 * dm)
        return Linv * ds * (M * M) - c0 * (dm * dm)

    B = sf._ZETA_BRACKET / z
    lo, hi = min(np.sign(c0), 0.0) * B, max(np.sign(c0), 0.0) * B
    s_lo = np.sign(h(lo)) or 1.0
    count = 0
    for _ in range(n_rounds):
        w, j = hi - lo, 0
        for r in range(8):
            count += 1
            if not h(lo + ((r + 1.0) * (1.0 / 9.0)) * w) * s_lo > 0.0:
                break
            j += 1
        lo, hi = lo + j * (1.0 / 9.0) * w, lo + min(j + 1.0, 9.0) * (1.0 / 9.0) * w
    return count


def test_surface_conditions_count_the_probes_of_an_early_stopping_solve():
    """``probes`` equals a scalar replay of rounds that stop at their first
    probe past the sign change (the kernel's solve) on a sample of the
    oracle grid; a neutral state takes one probe per round, and the grid's
    mean is about half of the 8 per round."""
    arr = np.asarray(_state_grid(), dtype=np.float64)
    n = len(arr)
    a = lambda x: _t(np.broadcast_to(x, (n,)).copy())  # noqa: E731
    cond = sf.surface_conditions(
        ps, u_atm=a(arr[:, 0]), theta_atm=a(290.0 + arr[:, 1]), q_atm=a(0.01), u_sfc=a(0.0),
        theta_sfc=a(290.0), q_sfc=a(0.01 - arr[:, 2]), z_atm=a(arr[:, 3]), z_0m=a(arr[:, 4]),
        z_0s=a(arr[:, 4]), theta_scale=a(290.0),
    )
    probes = cond["probes"].numpy()
    neutral = (arr[:, 1] == 0.0) & (arr[:, 2] == 0.0)
    assert neutral.any() and np.all(probes[neutral] == 20)
    assert np.all((probes >= 20) & (probes <= 160)) and 60 < probes.mean() < 120
    for i in np.random.default_rng(3).choice(n, 12, replace=False):
        assert probes[i] == _early_stop_probes(arr[i]), arr[i]


def test_surface_conditions_f32_match_jax_f32():
    _, ref = _grid_conditions(jsf, torch.float32)
    _, got = _grid_conditions(sf, torch.float32)
    assert got["x_star0"].dtype == np.float32
    for i in range(3):
        r = ref[f"x_star{i}"].astype(np.float64)
        np.testing.assert_allclose(got[f"x_star{i}"], r, rtol=1e-5, atol=1e-5 * np.max(np.abs(r)), err_msg=str(i))


def _port_atmos_model(jm):
    return model_from_reference(jm, device="cpu")


def test_turbulent_and_blended_fluxes_match_jax(jax_atmos_model):
    jm = jax_atmos_model
    m = _port_atmos_model(jm)
    rng = np.random.default_rng(5)
    v = rng.uniform(0.2, 0.58, 64)
    ti = rng.uniform(0.0, 0.05, 64)
    T = rng.uniform(289.0, 305.0, 64)
    w = rng.uniform(0.0, 1.0, 64)
    ref = jsf.compute_turbulent_surface_fluxes(jm.energy_model, jm.hydrology_model, jm, jnp.asarray(v),
                                               jnp.asarray(ti), jnp.asarray(T))
    got = sf.compute_turbulent_surface_fluxes(m.energy_model, m.hydrology_model, m, _t(v), _t(ti), _t(T))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13, atol=1e-20)
    ref = jsf.compute_blended_surface_fluxes(jm.energy_model, jm.hydrology_model, jm, jnp.asarray(v),
                                             jnp.asarray(ti), jnp.asarray(T), jnp.asarray(w))
    got = sf.compute_blended_surface_fluxes(m.energy_model, m.hydrology_model, m, _t(v), _t(ti), _t(T), _t(w))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-13, atol=1e-20, err_msg=k)
    q_sat = sf.q_vap_saturation_liquid(ps, _t(T), 1.17).numpy()
    np.testing.assert_allclose(q_sat, np.asarray(jsf.q_vap_saturation_liquid(jps, jnp.asarray(T), 1.17)), rtol=1e-14)


def test_time_varying_atmosphere_and_refusals(jax_atmos_model):
    """Callable atmosphere fields are evaluated at t (equal to the constant
    at t = 0); the fluxes need dynamic energy and hydrology (TypeError);
    the forcing is refused at the bottom face (ValueError), at construction
    too."""
    m = _port_atmos_model(jax_atmos_model)
    atmos = m.boundary_conditions.top
    diurnal = dataclasses.replace(
        atmos, theta_atm=lambda t: 299.0 + 5.0 * torch.sin(2 * np.pi * t / 86400.0),
        u_atm=lambda t: 0.34 + 0.1 * torch.sin(2 * np.pi * t / 86400.0),
    )
    mt = dataclasses.replace(m, boundary_conditions=dataclasses.replace(m.boundary_conditions, top=diurnal))
    state = (_t(0.54), _t(0.0), _t(295.0))
    t0 = torch.tensor(0.0, dtype=torch.float64)
    hf0, ev0 = sf.compute_turbulent_surface_fluxes(mt.energy_model, mt.hydrology_model, mt, *state, t=t0)
    hf, ev = sf.compute_turbulent_surface_fluxes(m.energy_model, m.hydrology_model, m, *state)
    assert torch.equal(hf0, hf) and torch.equal(ev0, ev)
    hf6, _ = sf.compute_turbulent_surface_fluxes(mt.energy_model, mt.hydrology_model, mt, *state,
                                                 t=torch.tensor(21600.0, dtype=torch.float64))
    assert float(torch.abs(hf6 - hf0)) > 1.0
    for energy, hydrology in ((PrescribedTemperatureModel(), PrescribedHydrologyModel()),
                              (SoilEnergyModel(), PrescribedHydrologyModel()),
                              (PrescribedTemperatureModel(), SoilHydrologyModel())):
        with pytest.raises(TypeError):
            sf.compute_turbulent_surface_fluxes(energy, hydrology, m, *state)
    X = {"vartheta_l": torch.full((10,), 0.55, dtype=torch.float64), "theta_i": torch.zeros(10, dtype=torch.float64),
         "T": torch.full((10,), 299.0, dtype=torch.float64)}
    grid = make_function_space(m.domain, torch.float64, "cpu")
    with pytest.raises(ValueError):
        boundary_fluxes(X, atmos, "bottom", m, grid, t0)
    with pytest.raises(ValueError, match="top of the soil column"):
        SoilColumnBC(top=SoilComponentBC(), bottom=atmos)
    water_only = dataclasses.replace(m, energy_model=PrescribedTemperatureModel())
    with pytest.raises(TypeError, match="Turbulent"):  # where the JAX rhs raises it
        make_rhs(water_only)({"soil": {"vartheta_l": X["vartheta_l"], "theta_i": X["theta_i"]}},
                             {"zc": grid.zc, "soil": {}}, t0)


@pytest.mark.parametrize("coefficient_update", ["stage", "step"])
def test_soil_rhs_with_a_most_top_matches_jax(coefficient_update):
    """The soil tendency with a MOST top == JAX's (stage coefficients, and
    the lagged rhs with its coefficients from the same state), on a column
    batch with per-column atmosphere fields over both Businger branches."""
    from landhydrology_tpu.models.soil.lagged import make_coefficient_fns as jax_coefficient_fns
    from tests.test_pallas_kernel import _model, _state
    from landhydrology_tpu import PrescribedAtmosForcing as JAtmos, VerticalFlux as JVerticalFlux

    rng = np.random.default_rng(11)
    base = _model(JVerticalFlux(0.0), JVerticalFlux(0.0))
    ncol = base.domain.batch_shape[0]
    top = JAtmos(u_atm=jnp.asarray(rng.uniform(0.3, 5.0, ncol)),
                 theta_atm=jnp.asarray(rng.uniform(281.0, 298.0, ncol)), z_atm=2.0, theta_scale=290.0,
                 rho_a_sfc=1.2, q_atm=jnp.asarray(rng.uniform(0.002, 0.012, ncol)))
    jm = dataclasses.replace(base, boundary_conditions=JSoilColumnBC(top=top, bottom=base.boundary_conditions.bottom),
                             coefficient_update=coefficient_update)
    Y = _state()
    grid = make_function_space(model_from_reference(jm, device="cpu").domain, torch.float64, "cpu")
    Ya = {"zc": jnp.asarray(grid.zc.numpy()), "soil": {}}
    t = 7.0
    m = model_from_reference(jm, device="cpu")
    Yt, Yat = state_from_numpy(Y, device="cpu"), state_from_numpy(Ya, device="cpu")
    tt = torch.tensor(t, dtype=torch.float64)
    if coefficient_update == "stage":
        ref = jax_make_rhs(jm)(Y, Ya, jnp.asarray(t))
        got = make_rhs(m)(Yt, Yat, tt)
    else:
        jc, jr = jax_coefficient_fns(jm)
        ref = jr(jc(Y, Ya, jnp.asarray(t)), Y, Ya, jnp.asarray(t))
        c, r = make_coefficient_fns(m)
        got = r(c(Yt, Yat, tt), Yt, Yat, tt)
    for k, v in ref["soil"].items():
        r_ = np.asarray(v)
        np.testing.assert_allclose(got["soil"][k].numpy(), r_, rtol=1e-13, atol=1e-13 * np.max(np.abs(r_)), err_msg=k)
    heat, _ = sf.compute_turbulent_surface_fluxes(m.energy_model, m.hydrology_model, m, Yt["soil"]["vartheta_l"][-1],
                                                  Yt["soil"]["theta_i"][-1], _t(np.full(ncol, 287.0)))
    assert float(heat.max()) > 0.0 > float(heat.min())  # both signs of the buoyancy


def test_prescribed_atmos_forcing_constructs():
    f = PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.005)
    assert f.u_atm == 2.0 and isinstance(VerticalFlux(0.0), VerticalFlux)
    with pytest.raises(TypeError):
        PrescribedAtmosForcing(u_atm=2.0)  # every field is required, as in JAX
