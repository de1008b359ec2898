"""Turbulent land-atmosphere surface fluxes via Monin-Obukhov similarity.

PyTorch port of ``landhydrology_tpu/models/soil/surface_fluxes.py``: the
saturation-humidity helpers, the Businger universal functions and the
fixed-round multisection solve of the Obukhov length, with the same
operations in the same order, so that the float64 results agree with the
JAX package to rounding.

- The arctans are the JAX package's polynomial forms (``torch.atan``
  differs from them by up to ~1e-11, which would miss rtol 1e-12).
- The solve is the 8-point multisection on the sign-restricted bracket
  ``|zeta| <= 50``: 20 rounds in float64; 4 rounds and a two-step
  regula-falsi polish in float32, chosen by the dtype.  The JAX package's
  Illinois alternative was measured slower there and is not ported.
- The clamps are ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip``'s
  (``water._maximum``, ``water._minimum``, ``water._clip``), which split
  the gradient evenly at a tie: the final false-position step ties with its
  bracket's edge, so ``torch.clamp`` there gave another gradient than
  ``jax.grad``.
- ``ops/cuda/column_kernel.py`` runs the same solve inside the column
  kernel (``csrc/surface_fluxes.cuh``, kernel modes B5 and B6).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from landhydrology_tpu_torch.constants import EarthParameterSet
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.water import _clip, _maximum, _minimum
from landhydrology_tpu_torch.models.soil.model import (
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any

#: Businger stable-regime slope and turbulent Prandtl number
_BUSINGER_A = 4.7
_PRANDTL_0 = 0.74
#: probes per multisection round; rounds per dtype (9^20 > 2^62 reaches
#: float64 precision; float32 adds the two-step falsi polish)
_N_SECTIONS = 8
_N_ROUNDS_F64 = 20
_N_ROUNDS_F32 = 4
#: bracket in zeta = z_atm / L; the bracketed answer saturates at its edge
#: in the critical-stability decoupling regime (flagged by the residual)
_ZETA_BRACKET = 50.0
#: stability-parameter clamp of the universal functions
_ZETA_MIN, _ZETA_MAX = -100.0, 100.0


# --------------------------------------------------------------------------
# Moist-thermodynamics helpers
# --------------------------------------------------------------------------


def saturation_vapor_pressure_liquid(param_set: EarthParameterSet, T: Array) -> Array:
    """Clausius-Clapeyron saturation vapor pressure over liquid with
    constant heat capacities."""
    dcp = param_set.cp_v - param_set.cp_l
    return (
        param_set.press_triple
        * (T / param_set.T_triple) ** (dcp / param_set.R_v)
        * torch.exp(
            (param_set.LH_v0 - dcp * param_set.T_0)
            / param_set.R_v
            * (1.0 / param_set.T_triple - 1.0 / T)
        )
    )


def q_vap_saturation_liquid(param_set: EarthParameterSet, T: Array, rho: Array) -> Array:
    """Saturation specific humidity over a plane liquid surface."""
    return saturation_vapor_pressure_liquid(param_set, T) / (rho * param_set.R_v * T)


def cp_m(param_set: EarthParameterSet, q_tot: Array) -> Array:
    """Isobaric specific heat of moist air with all moisture in vapor."""
    return param_set.cp_d + (param_set.cp_v - param_set.cp_d) * q_tot


# --------------------------------------------------------------------------
# Businger universal functions
# --------------------------------------------------------------------------


def _odd_poly(r: Array) -> Array:
    """The odd Taylor polynomial of arctan to r^11."""
    r2 = r * r
    return r * (
        1.0
        + r2
        * (
            -1.0 / 3.0
            + r2
            * (
                1.0 / 5.0
                + r2 * (-1.0 / 7.0 + r2 * (1.0 / 9.0 + r2 * (-1.0 / 11.0)))
            )
        )
    )


def _arctan_halved(x: Array, reductions: int) -> Array:
    s = torch.sign(x)
    r = torch.abs(x)
    for _ in range(reductions):
        r = r / (1.0 + torch.sqrt(1.0 + r * r))
    return s * float(2**reductions) * _odd_poly(r)


def arctan_kernel_safe(x: Array) -> Array:
    """arctan by three half-angle reductions and the odd Taylor polynomial
    (accurate to ~1e-11 over the stability-function range)."""
    return _arctan_halved(x, 3)


def _arctan_reduced(r: Array) -> Array:
    """arctan for |r| <= ~0.75: two half-angle reductions and the
    polynomial (error < 2e-11)."""
    return _arctan_halved(r, 2)


def psi_m(zeta: Array) -> Array:
    """Integrated momentum stability function (Businger 1971)."""
    zeta = _clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_un = _minimum(zeta, 0.0)
    x = torch.sqrt(torch.sqrt(1.0 - 15.0 * zeta_un))
    one_px = 1.0 + x
    unstable = (
        torch.log(one_px * one_px * (1.0 + x * x) / 8.0)
        - 2.0 * arctan_kernel_safe(x)
        + math.pi / 2.0
    )
    stable = -_BUSINGER_A * _maximum(zeta, 0.0)
    return torch.where(zeta < 0.0, unstable, stable)


def psi_h(zeta: Array) -> Array:
    """Integrated scalar (heat/moisture) stability function."""
    zeta = _clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_un = _minimum(zeta, 0.0)
    y = torch.sqrt(1.0 - 9.0 * zeta_un)
    unstable = 2.0 * torch.log((1.0 + y) / 2.0)
    stable = -_BUSINGER_A / _PRANDTL_0 * _maximum(zeta, 0.0)
    return torch.where(zeta < 0.0, unstable, stable)


def psi_m_diff(zeta: Array, zeta_0: Array) -> Array:
    """``psi_m(zeta) - psi_m(zeta_0)`` for same-sign pairs: one log of a
    ratio and one arctan of ``(x - x0) / (1 + x x0)``."""
    zeta = _clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_0 = _clip(zeta_0, _ZETA_MIN, _ZETA_MAX)
    x = torch.sqrt(torch.sqrt(1.0 - 15.0 * _minimum(zeta, 0.0)))
    x0 = torch.sqrt(torch.sqrt(1.0 - 15.0 * _minimum(zeta_0, 0.0)))
    one_px = 1.0 + x
    one_px0 = 1.0 + x0
    ratio = (one_px * one_px * (1.0 + x * x)) / (one_px0 * one_px0 * (1.0 + x0 * x0))
    atan_arg = (x - x0) / (1.0 + x * x0)
    unstable = torch.log(ratio) - 2.0 * _arctan_reduced(atan_arg)
    stable = -_BUSINGER_A * (_maximum(zeta, 0.0) - _maximum(zeta_0, 0.0))
    return torch.where(zeta < 0.0, unstable, stable)


def psi_h_diff(zeta: Array, zeta_0: Array) -> Array:
    """``psi_h(zeta) - psi_h(zeta_0)`` for same-sign pairs."""
    zeta = _clip(zeta, _ZETA_MIN, _ZETA_MAX)
    zeta_0 = _clip(zeta_0, _ZETA_MIN, _ZETA_MAX)
    y = torch.sqrt(1.0 - 9.0 * _minimum(zeta, 0.0))
    y0 = torch.sqrt(1.0 - 9.0 * _minimum(zeta_0, 0.0))
    unstable = 2.0 * torch.log((1.0 + y) / (1.0 + y0))
    stable = (
        -_BUSINGER_A
        / _PRANDTL_0
        * (_maximum(zeta, 0.0) - _maximum(zeta_0, 0.0))
    )
    return torch.where(zeta < 0.0, unstable, stable)


# --------------------------------------------------------------------------
# The MOST solve
# --------------------------------------------------------------------------


def _log(x):
    return torch.log(x) if torch.is_tensor(x) else math.log(x)


def surface_conditions(
    param_set: EarthParameterSet,
    u_atm: Array,
    theta_atm: Array,
    q_atm: Array,
    u_sfc: Array,
    theta_sfc: Array,
    q_sfc: Array,
    z_atm: Array,
    z_0m: Array,
    z_0s: Array,
    theta_scale: Array,
) -> dict:
    """Solve MOST for the scales ``(u_star, theta_star, q_star)`` and the
    Obukhov length ``L``, elementwise over the column batch.

    The root of the division-free consistency equation ``h(1/L)`` is
    bracketed on ``[0, sign(c0) 50 / z_atm]`` (its sign is that of the
    buoyancy constant ``c0``; ``c0 == 0`` is the neutral root 1/L = 0) and
    narrowed by 8-point multisection rounds, each keeping the first
    sub-interval with a sign change; a regula-falsi step on the final
    bracket finishes it.  ``residual`` is the larger of the final half
    bracket and the consistency defect (large in the decoupling regime).
    ``probes`` counts the evaluations of ``h`` that the rounds need when
    each round stops at its first probe past the sign change (``j + 1``,
    at most 8, per round), as the CUDA kernel's solve evaluates them: the
    bracket is the same, the work depends on where the root lies.
    Inputs are tensors or Python scalars; at least one must be a tensor.
    """
    kappa = param_set.von_karman_const
    g = param_set.grav
    du = u_atm - u_sfc
    dtheta = theta_atm - theta_sfc
    dq = q_atm - q_sfc

    log_m = _log(z_atm / z_0m)
    log_s = _log(z_atm / z_0s)

    zero = (
        du * 0.0 + dtheta * 0.0 + dq * 0.0 + z_atm * 0.0 + z_0m * 0.0
        + z_0s * 0.0 + theta_scale * 0.0
    )
    if not torch.is_tensor(zero):
        raise TypeError("surface_conditions needs at least one tensor input")

    def denoms(Linv):
        zeta = z_atm * Linv
        zeta_0m = z_0m * Linv
        zeta_0s = z_0s * Linv
        denom_m = log_m - psi_m_diff(zeta, zeta_0m)
        denom_s = _PRANDTL_0 * (log_s - psi_h_diff(zeta, zeta_0s))
        denom_m = _maximum(denom_m, 1e-3)
        denom_s = _maximum(denom_s, 1e-3)
        return denom_m, denom_s

    eps_vi = param_set.molmass_ratio - 1.0
    b_const = (1.0 + eps_vi * q_atm) * dtheta + eps_vi * theta_scale * dq
    c0 = kappa * kappa * g * b_const / theta_scale
    kdu = kappa * du

    def f(Linv):
        denom_m, denom_s = denoms(Linv)
        u_star = kappa * du / denom_m
        theta_star = kappa * dtheta / denom_s
        q_star = kappa * dq / denom_s
        theta_v_star = theta_star * (1.0 + eps_vi * q_atm) + eps_vi * theta_scale * q_star
        u_star_safe = _maximum(u_star, 1e-6)
        return Linv - kappa * g * theta_v_star / (u_star_safe * u_star_safe * theta_scale)

    def h(Linv):
        """``f`` multiplied through by the positive ``denom_s u_star_safe^2
        denom_m^2``: the same roots and signs, no division."""
        denom_m, denom_s = denoms(Linv)
        M = torch.maximum(kdu + zero, 1e-6 * denom_m)
        return Linv * denom_s * (M * M) - c0 * (denom_m * denom_m)

    B = _ZETA_BRACKET / z_atm + zero
    sgn = torch.sign(c0 + zero)
    lo = _minimum(sgn, 0.0) * B
    hi = _maximum(sgn, 0.0) * B
    s_lo = torch.sign(h(lo))
    s_lo = torch.where(s_lo == 0.0, 1.0, s_lo)
    is_f64 = zero.dtype == torch.float64
    n_rounds = _N_ROUNDS_F64 if is_f64 else _N_ROUNDS_F32
    k = _N_SECTIONS
    inv = 1.0 / (k + 1.0)
    probes = torch.zeros_like(zero)
    for _ in range(n_rounds):
        w = hi - lo
        h_mids = h(torch.stack([lo + ((r + 1.0) * inv) * w for r in range(k)]))
        # j: the number of leading probes still on lo's side
        alive = h_mids[0] * s_lo > 0.0
        j = alive.to(zero.dtype)
        for r in range(1, k):
            alive = alive & (h_mids[r] * s_lo > 0.0)
            j = j + alive.to(zero.dtype)
        lo, hi = lo + j * inv * w, lo + torch.clamp(j + 1.0, max=k + 1.0) * inv * w
        probes = probes + torch.clamp(j + 1.0, max=k)
    h_lo2 = h(lo)
    h_hi2 = h(hi)
    if not is_f64:
        # float32: a first false-position step keeps the sign-change side
        den1 = h_hi2 - h_lo2
        ok1 = (h_lo2 * h_hi2 <= 0.0) & (torch.abs(den1) > 0.0)
        x1 = (lo * h_hi2 - hi * h_lo2) / torch.where(ok1, den1, 1.0)
        x1 = _clip(x1, lo, hi)
        h1 = h(x1)
        left = h_lo2 * h1 <= 0.0
        lo, hi, h_lo2, h_hi2 = (
            torch.where(ok1 & ~left, x1, lo),
            torch.where(ok1 & left, x1, hi),
            torch.where(ok1 & ~left, h1, h_lo2),
            torch.where(ok1 & left, h1, h_hi2),
        )
    den = h_hi2 - h_lo2
    use_falsi = (h_lo2 * h_hi2 <= 0.0) & (torch.abs(den) > 0.0)
    Linv_falsi = (lo * h_hi2 - hi * h_lo2) / torch.where(use_falsi, den, 1.0)
    Linv_falsi = _clip(Linv_falsi, lo, hi)
    Linv = torch.where(use_falsi, Linv_falsi, 0.5 * (lo + hi))
    delta = 0.5 * (hi - lo)
    if zero.requires_grad:
        Linv = _with_root_derivative(Linv, use_falsi, h)

    denom_m, denom_s = denoms(Linv)
    u_star = kappa * du / denom_m
    theta_star = kappa * dtheta / denom_s
    q_star = kappa * dq / denom_s
    L = torch.where(torch.abs(Linv) > 1e-30, 1.0 / Linv, math.inf)
    return {
        "x_star": (u_star, theta_star, q_star),
        "L_mo": L,
        "residual": torch.maximum(torch.abs(delta), torch.abs(f(Linv))),
        "denoms": (denom_m, denom_s),
        "probes": probes,
    }


def _with_root_derivative(Linv, solved, h):
    """``Linv`` with, where the solve bracketed a root (``solved``), the
    derivative of that root by the implicit-function theorem,
    ``d Linv = -(dh/d inputs) / (dh/d Linv)``, in place of the derivative of
    the solve's operations; the values are unchanged.

    The solve ends on a bracket one or two ulps wide, where ``h`` is at its
    rounding level, so the derivative of its last false-position step is
    the quotient of two rounding errors: ``torch.autograd`` and ``jax.grad``
    of it miss the finite-difference derivative of the root by factors of
    2 to 40, and differ from each other with the last bits of the forward.
    Elsewhere (no sign change, or the neutral root ``c0 == 0``) the
    derivative stays that of the solve's operations."""
    root = Linv.detach()
    with torch.enable_grad():
        probe = root.clone().requires_grad_(True)
        h_root = h(probe)
        (slope,) = torch.autograd.grad(h_root, probe, torch.ones_like(h_root), retain_graph=True)
    step = -h(root) / torch.where(solved, slope, 1.0)
    return torch.where(solved, root + (step - step.detach()), Linv)


# --------------------------------------------------------------------------
# The soil-facing flux computation
# --------------------------------------------------------------------------


def _resolve_atmos(atmos, t):
    """The atmosphere BC with its callable fields evaluated at ``t``."""
    fields = dataclasses.fields(atmos)
    if any(callable(getattr(atmos, f.name)) for f in fields):
        atmos = dataclasses.replace(atmos, **{
            f.name: getattr(atmos, f.name)(t)
            for f in fields if callable(getattr(atmos, f.name))
        })
    return atmos


def _soil_surface_humidity(model, hydrology, vartheta_l, theta_i, T, rho_a):
    """(q_sat, q_surf): the saturation humidity at the surface and the
    soil-moisture-corrected ``q_surf = q_sat exp(g psi / R_v T)``."""
    sp = model.soil_param_set
    param_set = model.earth_param_set
    hm = hydrology.hydraulic_model
    q_sat = q_vap_saturation_liquid(param_set, T, rho_a)
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
    S_l_eff = _minimum(sw.effective_saturation(nu_eff, theta_l, hm.theta_r), 1.0)
    psi = sw.matric_potential(hm, S_l_eff)
    correction = torch.exp(param_set.grav * psi / param_set.R_v / T)
    return q_sat, q_sat * correction


def _require_dynamic(energy, hydrology):
    if not isinstance(energy, SoilEnergyModel) or not isinstance(
        hydrology, SoilHydrologyModel
    ):
        raise TypeError(
            "Turbulent surface fluxes require dynamic SoilEnergyModel and "
            "SoilHydrologyModel components."
        )


def _assemble_fluxes(param_set, atmos, T, q_sfc, u_star, t_star, q_star):
    """(heat flux, water volume flux), positive along +z, from the MOST
    scales."""
    cpm = cp_m(param_set, q_sfc)
    T_ref = param_set.T_0
    h_d = param_set.cp_d * (T - T_ref) + param_set.R_d * T_ref
    E = -atmos.rho_a_sfc * u_star * q_star
    dry_static_energy_flux = -cpm * atmos.rho_a_sfc * u_star * t_star - h_d * E
    vapor_static_energy_flux = (param_set.cp_v * (T - T_ref) + param_set.LH_v0) * E
    E_vol = E / param_set.rho_cloud_liq
    return dry_static_energy_flux + vapor_static_energy_flux, E_vol


def _conditions(model, atmos, T, q_sfc):
    sp = model.soil_param_set
    return surface_conditions(
        model.earth_param_set,
        u_atm=atmos.u_atm,
        theta_atm=atmos.theta_atm,
        q_atm=atmos.q_atm,
        u_sfc=torch.zeros_like(T),
        theta_sfc=T,
        q_sfc=q_sfc,
        z_atm=atmos.z_atm,
        z_0m=sp.z_0m,
        z_0s=sp.z_0s,
        theta_scale=atmos.theta_scale,
    )


def _as_tensor(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def compute_turbulent_surface_fluxes(
    energy, hydrology, model: SoilModel, vartheta_l: Array, theta_i: Array, T: Array, t: Array = 0.0
) -> tuple:
    """Surface (heat flux, water volume flux), positive upward, from MOST
    given the soil surface state; atmosphere fields that are callables are
    evaluated at ``t``.  Requires dynamic energy and hydrology."""
    _require_dynamic(energy, hydrology)
    T = torch.as_tensor(T, dtype=model.float_dtype)
    vartheta_l, theta_i = _as_tensor(vartheta_l, T), _as_tensor(theta_i, T)
    atmos = _resolve_atmos(model.boundary_conditions.top, t)
    param_set = model.earth_param_set
    _, q_surf = _soil_surface_humidity(model, hydrology, vartheta_l, theta_i, T, atmos.rho_a_sfc)
    u_star, t_star, q_star = _conditions(model, atmos, T, q_surf)["x_star"]
    return _assemble_fluxes(param_set, atmos, T, q_surf, u_star, t_star, q_star)


def compute_blended_surface_fluxes(
    energy, hydrology, model: SoilModel, vartheta_l: Array, theta_i: Array, T: Array, w: Array,
    t: Array = 0.0,
) -> dict:
    """Pond/bare-soil surface fluxes from one MOST solve over the blended
    surface humidity ``q_eff = (1-w) q_soil + w q_sat`` (pond fraction
    ``w``).  The latent flux is linear in the surface humidity at the
    converged profile, so the per-component split is exact.  Returns
    ``{"heat_flux", "evap_soil", "evap_pond"}`` with the evaporation terms
    already weighted (volume fluxes, positive upward)."""
    _require_dynamic(energy, hydrology)
    atmos = _resolve_atmos(model.boundary_conditions.top, t)
    param_set = model.earth_param_set
    q_sat, q_soil = _soil_surface_humidity(model, hydrology, vartheta_l, theta_i, T, atmos.rho_a_sfc)
    one_m_w = 1.0 - w
    q_eff = one_m_w * q_soil + w * q_sat
    conditions = _conditions(model, atmos, T, q_eff)
    u_star, t_star, _ = conditions["x_star"]
    _, denom_s = conditions["denoms"]
    r_s = param_set.von_karman_const / denom_s
    q_star_soil = (atmos.q_atm - q_soil) * r_s
    q_star_pond = (atmos.q_atm - q_sat) * r_s
    heat_soil, E_soil = _assemble_fluxes(param_set, atmos, T, q_soil, u_star, t_star, q_star_soil)
    heat_pond, E_pond = _assemble_fluxes(param_set, atmos, T, q_sat, u_star, t_star, q_star_pond)
    return {
        "heat_flux": one_m_w * heat_soil + w * heat_pond,
        "evap_soil": one_m_w * E_soil,
        "evap_pond": w * E_pond,
    }
