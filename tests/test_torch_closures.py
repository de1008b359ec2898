"""The PyTorch port's water/heat closures against the JAX package's, in
float64 on seeded numpy grids, including the clamp edges: S -> 1, S > 1,
S -> 0, theta_w -> 0 and theta_i on both sides of eps.  Bar: rtol 1e-13
(the eager f64 bar of the port)."""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil import heat as jh
from landhydrology_tpu.models.soil import water as jw
from landhydrology_tpu.models.soil.params import SoilParams as JSoilParams
from landhydrology_tpu_torch.constants import default_earth_param_set as tps
from landhydrology_tpu_torch.models.soil import heat as th
from landhydrology_tpu_torch.models.soil import water as tw
from landhydrology_tpu_torch.models.soil.params import SoilParams as TSoilParams

RTOL = 1e-13
NZ, NCOL = 24, 16
EPS = np.finfo(np.float64).eps


def _close(t_out, j_out):
    np.testing.assert_allclose(
        np.asarray(t_out), np.asarray(j_out), rtol=RTOL, atol=0.0
    )


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _j(x):
    return jnp.asarray(np.asarray(x), dtype=jnp.float64)


def _vg_params(rng, per_column):
    if not per_column:
        return dict(n=1.9, alpha=2.6, Ksat=1e-6, theta_r=0.04)
    return dict(
        n=rng.uniform(1.3, 3.5, NCOL),
        alpha=rng.uniform(1.5, 4.0, NCOL),
        Ksat=rng.uniform(1e-7, 1e-5, NCOL),
        theta_r=rng.uniform(0.0, 0.05, NCOL),
    )


def _hms(params):
    conv = {k: (v if np.ndim(v) == 0 else None) for k, v in params.items()}
    tp = {k: (conv[k] if conv[k] is not None else _t(v)) for k, v in params.items()}
    jp = {k: (conv[k] if conv[k] is not None else _j(v)) for k, v in params.items()}
    return tw.vanGenuchten(**tp), jw.vanGenuchten(**jp)


def _saturation_grid(rng):
    """S values on (nz, ncol), with the edge rows 0, tiny, eps/2, eps (the
    lower clip), S -> 1, 1, 1 + eps and > 1 spliced in.

    Near 1, S^(+-1/m) - 1 cancels: its relative rounding error is
    ~eps/(1 - S), so at the upper clip 1 - eps two libms' exp/log may keep
    different ulps of it and give K or psi that differ in the 7th digit.
    S -> 1 is therefore compared at 1 - 1e-2 (error ~2e-14), and the clip
    itself by :func:`test_upper_clip_is_applied`."""
    S = rng.uniform(0.0, 1.2, (NZ, NCOL))
    edges = [0.0, 1e-300, 0.5 * EPS, EPS, 1.0 - 1e-2, 1.0, 1.0 + EPS, 1.3]
    for i, v in enumerate(edges):
        S[i] = v
    return S


def test_upper_clip_is_applied():
    """Every S in [1 - eps, 1) is evaluated at the clip 1 - eps."""
    hm = tw.vanGenuchten(n=1.9, alpha=2.6, Ksat=1e-6, theta_r=0.04)
    below = _t([1.0 - EPS, 1.0 - 0.5 * EPS])
    K = tw.hydraulic_conductivity(hm, below, 1.0, 1.0)
    psi = tw.matric_potential(hm, below)
    assert K[0] == K[1] and psi[0] == psi[1]
    assert 0.0 < K[0] < 1e-6 and psi[0] < 0.0


@pytest.mark.parametrize("per_column", [False, True], ids=["scalar", "per_column"])
def test_van_genuchten_closures(per_column):
    rng = np.random.default_rng(11)
    thm, jhm = _hms(_vg_params(rng, per_column))
    S = _saturation_grid(rng)
    _close(tw.matric_potential(thm, _t(S)), jw.matric_potential(jhm, _j(S)))
    visc = rng.uniform(0.5, 1.5, (NZ, NCOL))
    imp = rng.uniform(0.1, 1.0, (NZ, NCOL))
    _close(
        tw.hydraulic_conductivity(thm, _t(S), _t(visc), _t(imp)),
        jw.hydraulic_conductivity(jhm, _j(S), _j(visc), _j(imp)),
    )
    _close(
        tw.hydraulic_conductivity(thm, _t(S), 1.0, 1.0),
        jw.hydraulic_conductivity(jhm, _j(S), 1.0, 1.0),
    )
    # pressure head across the saturated/unsaturated switch
    nu_eff = rng.uniform(0.35, 0.5, NCOL)
    vl = nu_eff[None, :] * rng.uniform(0.0, 1.1, (NZ, NCOL))
    vl[0] = nu_eff
    vl[1] = nu_eff + 1e-3
    vl[2] = 0.0
    for S_s in (1e-3, _t(rng.uniform(1e-4, 1e-2, NCOL))):
        jS_s = S_s if isinstance(S_s, float) else _j(S_s.numpy())
        _close(
            tw.pressure_head(thm, _t(vl), _t(nu_eff), S_s),
            jw.pressure_head(jhm, _j(vl), _j(nu_eff), jS_s),
        )
    porosity = rng.uniform(0.4, 0.55, NCOL)
    _close(
        tw.effective_saturation(_t(porosity), _t(vl), thm.theta_r),
        jw.effective_saturation(_j(porosity), _j(vl), jhm.theta_r),
    )
    _close(tw.volumetric_liquid_fraction(_t(vl), _t(nu_eff)),
           jw.volumetric_liquid_fraction(_j(vl), _j(nu_eff)))
    # retention-curve inverse and the hydrostatic profile
    psi = -rng.uniform(0.0, 5.0, (NZ, NCOL))
    _close(tw.inverse_matric_potential(thm, _t(psi)),
           jw.inverse_matric_potential(jhm, _j(psi)))
    z = np.linspace(-2.0, 0.0, NZ)[:, None] + np.zeros((NZ, NCOL))
    _close(
        tw.hydrostatic_profile(thm, _t(z), -0.7, _t(porosity), 1e-3),
        jw.hydrostatic_profile(jhm, _j(z), -0.7, _j(porosity), 1e-3),
    )


def test_inverse_matric_potential_rejects_positive_head():
    with pytest.raises(ValueError, match="positive"):
        tw.inverse_matric_potential(tw.vanGenuchten(), _t(np.array([-1.0, 0.5])))


def test_conductivity_factors_and_ice_fraction():
    rng = np.random.default_rng(12)
    T = rng.uniform(260.0, 310.0, (NZ, NCOL))
    for tf, jf in [
        (tw.NoEffect(), jw.NoEffect()),
        (tw.TemperatureDependentViscosity(), jw.TemperatureDependentViscosity()),
        (
            tw.TemperatureDependentViscosity(gamma=_t(rng.uniform(0.01, 0.04, NCOL))),
            None,
        ),
    ]:
        if jf is None:
            jf = jw.TemperatureDependentViscosity(gamma=_j(tf.gamma.numpy()))
        _close(tw.viscosity_factor(tf, _t(T)), jw.viscosity_factor(jf, _j(T)))
    theta_l = rng.uniform(0.0, 0.4, (NZ, NCOL))
    theta_i = rng.uniform(0.0, 0.2, (NZ, NCOL))
    theta_l[0], theta_i[0] = 0.0, 0.0  # theta_w -> 0: guarded 0/0
    theta_l[1], theta_i[1] = 0.0, 0.5 * EPS
    theta_i[2] = 0.0
    f_i = tw.ice_fraction_of_water(_t(theta_l), _t(theta_i))
    _close(f_i, jw.ice_fraction_of_water(_j(theta_l), _j(theta_i)))
    for tf, jf in [
        (tw.NoEffect(), jw.NoEffect()),
        (tw.IceImpedance(), jw.IceImpedance()),
        (tw.IceImpedance(omega=3.5), jw.IceImpedance(omega=3.5)),
    ]:
        _close(tw.impedance_factor(tf, f_i), jw.impedance_factor(jf, _j(f_i.numpy())))


def _soil_params(rng, per_column):
    if not per_column:
        return TSoilParams(nu=0.45, nu_ss_om=0.1), JSoilParams(nu=0.45, nu_ss_om=0.1)
    fields = dict(
        nu=rng.uniform(0.4, 0.55, NCOL),
        nu_ss_om=rng.uniform(0.0, 0.2, NCOL),
        nu_ss_quartz=rng.uniform(0.2, 0.9, NCOL),
        nu_ss_gravel=rng.uniform(0.0, 0.1, NCOL),
        a=rng.uniform(0.2, 0.3, NCOL),
        b=rng.uniform(15.0, 20.0, NCOL),
        kappa_solid=rng.uniform(2.0, 8.0, NCOL),
        rho_p=rng.uniform(2500.0, 2800.0, NCOL),
        kappa_dry_parameter=rng.uniform(0.04, 0.06, NCOL),
        kappa_sat_unfrozen=rng.uniform(1.0, 2.5, NCOL),
        kappa_sat_frozen=rng.uniform(2.0, 4.0, NCOL),
        rho_c_ds=rng.uniform(1.0e6, 2.0e6, NCOL),
    )
    return (
        TSoilParams(**{k: _t(v) for k, v in fields.items()}),
        JSoilParams(**{k: _j(v) for k, v in fields.items()}),
    )


@pytest.mark.parametrize("per_column", [False, True], ids=["scalar", "per_column"])
def test_heat_closures(per_column):
    rng = np.random.default_rng(13)
    tsp, jsp = _soil_params(rng, per_column)
    theta_l = rng.uniform(0.0, 0.45, (NZ, NCOL))
    theta_i = rng.uniform(0.0, 0.2, (NZ, NCOL))
    theta_l[0], theta_i[0] = 0.0, 0.0  # dry: kappa_sat -> 0
    theta_l[1], theta_i[1] = 0.3, 0.5 * EPS  # theta_i just below eps
    theta_l[2], theta_i[2] = 0.3, 2.0 * EPS  # just above eps
    theta_i[3] = 0.0
    theta_l[4], theta_i[4] = 0.5, 0.2  # S_r > 1
    T = rng.uniform(260.0, 310.0, (NZ, NCOL))
    rho_e = rng.uniform(-5e7, 5e7, (NZ, NCOL))
    tl, ti, jl, ji = _t(theta_l), _t(theta_i), _j(theta_l), _j(theta_i)

    rcs_t = th.volumetric_heat_capacity(tl, ti, tsp.rho_c_ds, tps)
    rcs_j = jh.volumetric_heat_capacity(jl, ji, jsp.rho_c_ds, jps)
    _close(rcs_t, rcs_j)
    _close(th.temperature_from_rho_e_int(_t(rho_e), ti, rcs_t, tps),
           jh.temperature_from_rho_e_int(_j(rho_e), ji, rcs_j, jps))
    _close(th.volumetric_internal_energy(ti, rcs_t, _t(T), tps),
           jh.volumetric_internal_energy(ji, rcs_j, _j(T), jps))
    _close(th.volumetric_internal_energy_liq(_t(T), tps),
           jh.volumetric_internal_energy_liq(_j(T), jps))
    S_r_t = th.relative_saturation(tl, ti, tsp.nu)
    S_r_j = jh.relative_saturation(jl, ji, jsp.nu)
    _close(S_r_t, S_r_j)
    Ke_t = th.kersten_number(ti, S_r_t, tsp)
    Ke_j = jh.kersten_number(ji, S_r_j, jsp)
    _close(Ke_t, Ke_j)
    ks_t = th.saturated_thermal_conductivity(tl, ti, tsp.kappa_sat_unfrozen, tsp.kappa_sat_frozen)
    ks_j = jh.saturated_thermal_conductivity(jl, ji, jsp.kappa_sat_unfrozen, jsp.kappa_sat_frozen)
    _close(ks_t, ks_j)
    kd_t, kd_j = th.k_dry(tps, tsp), jh.k_dry(jps, jsp)
    _close(kd_t, kd_j)
    _close(th.thermal_conductivity(kd_t, Ke_t, ks_t), jh.thermal_conductivity(kd_j, Ke_j, ks_j))
    # the unfrozen-only form used under assume_no_ice (scalar theta_i)
    _close(th.kersten_number(0.0, S_r_t, tsp), jh.kersten_number(0.0, S_r_j, jsp))


def test_solid_and_saturated_conductivity_helpers():
    args = (0.1, 0.6, 7.7, 2.5, 0.25)
    assert th.k_solid(*args) == jh.k_solid(*args)
    ks = th.k_solid(*args)
    assert th.ksat_frozen(ks, 0.45, 2.29) == jh.ksat_frozen(ks, 0.45, 2.29)
    assert th.ksat_unfrozen(ks, 0.45, 0.57) == jh.ksat_unfrozen(ks, 0.45, 0.57)
    assert th.rho_b_ss(0.45, 2700.0) == jh.rho_b_ss(0.45, 2700.0)
    porosity = np.array([0.4, 0.5])
    _close(th.ksat_frozen(ks, _t(porosity), 2.29), jh.ksat_frozen(ks, _j(porosity), 2.29))


def test_earth_parameters_match():
    for name in ("T_0", "LH_f0", "rho_cp_l", "rho_cp_i", "rho_cloud_ice",
                 "K_therm", "R_d", "R_v", "cp_d", "molmass_ratio", "grav"):
        assert getattr(tps, name) == getattr(jps, name), name
    assert math.isclose(tps.LH_f0, 333600.0)
