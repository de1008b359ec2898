"""Soil thermal parameterizations.

PyTorch port of ``landhydrology_tpu/models/soil/heat.py``: branch-free
tensor functions; the branches on ``theta_w < eps`` and ``theta_i < eps``
are selects with clamped operands.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from landhydrology_tpu_torch.constants import EarthParameterSet
from landhydrology_tpu_torch.models.soil.water import _eps_of, _maximum, _tiny_of

Array = Any


def temperature_from_rho_e_int(
    rho_e_int: Array, theta_i: Array, rho_c_s: Array, param_set: EarthParameterSet
) -> Array:
    """T = T_0 + (rho_e_int + theta_i rho_i LH_f0) / rho_c_s."""
    return param_set.T_0 + (
        rho_e_int + theta_i * param_set.rho_cloud_ice * param_set.LH_f0
    ) / rho_c_s


def volumetric_heat_capacity(
    theta_l: Array, theta_i: Array, rho_c_ds: Array, param_set: EarthParameterSet
) -> Array:
    """rho_c_s = rho_c_ds + theta_l rho cp_l + theta_i rho cp_i."""
    return rho_c_ds + theta_l * param_set.rho_cp_l + theta_i * param_set.rho_cp_i


def volumetric_internal_energy(
    theta_i: Array, rho_c_s: Array, T: Array, param_set: EarthParameterSet
) -> Array:
    """rho_e_int = rho_c_s (T - T_0) - theta_i rho_i LH_f0."""
    return (
        rho_c_s * (T - param_set.T_0)
        - theta_i * param_set.rho_cloud_ice * param_set.LH_f0
    )


def volumetric_internal_energy_liq(T: Array, param_set: EarthParameterSet) -> Array:
    """rho_e_int_l = rho cp_l (T - T_0)."""
    return param_set.rho_cp_l * (T - param_set.T_0)


def _log_param(x):
    """log of a conductivity parameter: in Python double for a scalar, in
    the tensor's dtype for a per-column tensor."""
    return math.log(x) if isinstance(x, (int, float)) else torch.log(x)


def saturated_thermal_conductivity(
    theta_l: Array, theta_i: Array, kappa_sat_unfrozen: Array, kappa_sat_frozen: Array
) -> Array:
    """kappa_sat = kappa_sat_unf^(theta_l/theta_w) kappa_sat_fr^(theta_i/theta_w),
    0 when theta_w < eps, as one exponential
    exp((theta_l ln k_unf + theta_i ln k_fr)/theta_w)."""
    theta_w = theta_l + theta_i
    r_theta_w = 1.0 / _maximum(theta_w, _eps_of(theta_w))
    ln_unf = _log_param(kappa_sat_unfrozen)
    ln_fr = _log_param(kappa_sat_frozen)
    kappa = torch.exp((theta_l * ln_unf + theta_i * ln_fr) * r_theta_w)
    return torch.where(theta_w < _eps_of(theta_w), 0.0, kappa)


def relative_saturation(theta_l: Array, theta_i: Array, porosity: Array) -> Array:
    """S_r = (theta_l + theta_i)/porosity."""
    return (theta_l + theta_i) / porosity


def kersten_exponents(soil_params) -> tuple:
    """The three exponents of :func:`kersten_number`: the unfrozen S_r and
    bracket powers and the frozen S_r power."""
    a = soil_params.a
    nu_ss_om = soil_params.nu_ss_om
    e_unf = (1.0 + nu_ss_om - a * soil_params.nu_ss_quartz - soil_params.nu_ss_gravel) / 2.0
    return e_unf, 1.0 - nu_ss_om, 1.0 + nu_ss_om


def kersten_number(theta_i: Array, S_r: Array, soil_params) -> Array:
    """Balland & Arp Kersten number, unfrozen when ``theta_i < eps``:

    K_e = S_r^((1 + nu_ss_om - a nu_ss_quartz - nu_ss_gravel)/2)
    * ((1 + exp(-b S_r))^-3 - ((1 - S_r)/2)^3)^(1 - nu_ss_om), frozen
    K_e = S_r^(1 + nu_ss_om).  The cube is expanded as products, the bracket
    is clamped before its log, and both branches share one log(S_r)."""
    b = soil_params.b
    e_unf, e_bracket, e_fr = kersten_exponents(soil_params)
    S_r_safe = _maximum(S_r, 0.0)
    half = (1.0 - S_r_safe) / 2.0
    t = 1.0 + torch.exp(-b * S_r_safe)
    bracket = 1.0 / (t * t * t) - half * half * half
    tiny = _tiny_of(S_r)
    ln_S = torch.log(_maximum(S_r_safe, tiny))
    ln_bracket = torch.log(_maximum(bracket, tiny))
    K_e_unfrozen = torch.exp(ln_S * e_unf + ln_bracket * e_bracket)
    K_e_frozen = torch.exp(ln_S * e_fr)
    unfrozen = theta_i < _eps_of(S_r)
    if not torch.is_tensor(unfrozen):  # scalar theta_i (assume_no_ice)
        return K_e_unfrozen if unfrozen else K_e_frozen
    return torch.where(unfrozen, K_e_unfrozen, K_e_frozen)


def thermal_conductivity(kappa_dry: Array, K_e: Array, kappa_sat: Array) -> Array:
    """kappa = K_e kappa_sat + (1 - K_e) kappa_dry."""
    return K_e * kappa_sat + (1.0 - K_e) * kappa_dry


def k_solid(
    nu_ss_om: Array,
    nu_ss_quartz: Array,
    kappa_quartz: Array,
    kappa_minerals: Array,
    kappa_om: Array,
) -> Array:
    """Geometric-mean solids conductivity."""
    return (
        kappa_om**nu_ss_om
        * kappa_quartz**nu_ss_quartz
        * kappa_minerals ** (1.0 - nu_ss_om - nu_ss_quartz)
    )


def ksat_frozen(kappa_solid: Array, porosity: Array, kappa_ice: Array) -> Array:
    """kappa_solid^(1-porosity) kappa_ice^porosity."""
    return kappa_solid ** (1.0 - porosity) * kappa_ice**porosity


def ksat_unfrozen(kappa_solid: Array, porosity: Array, kappa_l: Array) -> Array:
    """kappa_solid^(1-porosity) kappa_l^porosity."""
    return kappa_solid ** (1.0 - porosity) * kappa_l**porosity


def rho_b_ss(porosity: Array, rho_p: Array) -> Array:
    """Dry-soil bulk density (1 - porosity) rho_p."""
    return (1.0 - porosity) * rho_p


def k_dry(param_set: EarthParameterSet, soil_params) -> Array:
    """Dry thermal conductivity, Balland & Arp."""
    kappa_dry_parameter = soil_params.kappa_dry_parameter
    porosity = soil_params.nu
    rho_p = soil_params.rho_p
    kappa_solid = soil_params.kappa_solid
    kappa_air = param_set.K_therm
    rho_b = rho_b_ss(porosity, rho_p)
    numerator = (kappa_dry_parameter * kappa_solid - kappa_air) * rho_b + kappa_air * rho_p
    denom = rho_p - (1.0 - kappa_dry_parameter) * rho_b
    return numerator / denom
