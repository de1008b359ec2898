"""RHS assembly — the spatial discretization of the soil PDEs.

PyTorch port of ``landhydrology_tpu/models/soil/rhs.py``.
``make_rhs(model)`` dispatches on the (energy, hydrology) component types
and returns ``rhs(Y, Ya, t) -> dY`` over dicts of ``(nz, *batch)`` tensors:

- (Prescribed, Prescribed) -> no-op
- (Prescribed, SoilHydrology) -> Richards only:
  d vartheta_l/dt = -div(-K grad h), h = psi + z
- (SoilEnergy, Prescribed) -> heat only: d rho_e_int/dt = -div(-kappa grad T)
- (SoilEnergy, SoilHydrology) -> fully coupled, adds the advected liquid
  internal energy flux -rho_e_int_liq K grad h, and with ``FreezeThaw`` the
  phase-change rate sources (``EquilibriumFreezeThaw`` adds nothing here:
  its projection runs after each step)

With a ``LateralSurfaceCoupling`` the water-only and coupled branches add
the lateral surface tendency to the top cell.

This is the eager path; ``ops/cuda/column_kernel.py`` runs the coupled
branch inside one CUDA kernel.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from landhydrology_tpu_torch.domains import ColumnGrid, make_function_space
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.boundary import boundary_fluxes
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    FreezeThaw,
    phase_change_sources,
)
from landhydrology_tpu_torch.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.ops.stencil import diffusive_flux_faces, div_f2c

Array = Any


# --------------------------------------------------------------------------
# Auxiliary-state update
# --------------------------------------------------------------------------


def make_update_aux(component) -> Callable[[dict, Array, str], dict]:
    """Return ``update_aux(Ya, t, name) -> Ya`` refreshing prescribed fields
    from their (z, t) profiles; identity for dynamic components."""
    if isinstance(component, PrescribedTemperatureModel):

        def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
            soil = dict(Ya[name], T=component.T_profile(Ya["zc"], t))
            return dict(Ya, **{name: soil})

        return update_aux

    if isinstance(component, PrescribedHydrologyModel):

        def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
            zc = Ya["zc"]
            soil = dict(
                Ya[name],
                vartheta_l=component.vartheta_l_profile(zc, t),
                theta_i=component.theta_i_profile(zc, t),
            )
            return dict(Ya, **{name: soil})

        return update_aux

    def update_aux(Ya: dict, t: Array, name: str = "soil") -> dict:
        return Ya

    return update_aux


# --------------------------------------------------------------------------
# Shared physics sweeps
# --------------------------------------------------------------------------


def hydrology_center_fields(model: SoilModel, vartheta_l, theta_i, T):
    """Pointwise hydraulic fields on centers: (theta_l, K, psi).  With
    ``model.assume_no_ice`` the effective porosity is the porosity and the
    impedance factor is unity."""
    sp = model.soil_param_set
    hydrology = model.hydrology_model
    hm = hydrology.hydraulic_model
    if model.assume_no_ice:
        nu_eff = sp.nu
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        impedance_f = 1.0
    else:
        nu_eff = sp.nu - theta_i
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        f_i = sw.ice_fraction_of_water(theta_l, theta_i)
        impedance_f = sw.impedance_factor(hydrology.impedance_factor, f_i)
    viscosity_f = sw.viscosity_factor(hydrology.viscosity_factor, T)
    S = sw.effective_saturation(sp.nu, vartheta_l, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, viscosity_f, impedance_f)
    psi = sw.pressure_head(hm, vartheta_l, nu_eff, sp.S_s)
    return theta_l, K, psi


def energy_center_fields(model: SoilModel, theta_l, theta_i, rho_e_int=None, T=None):
    """Pointwise thermal fields on centers: (T, kappa, rho_c_s).  Either
    ``rho_e_int`` (T is diagnosed) or ``T`` (prescribed) is given.  With
    ``model.assume_no_ice`` the frozen branches drop out exactly."""
    sp = model.soil_param_set
    param_set = model.earth_param_set
    no_ice = model.assume_no_ice
    rho_c_s = sh.volumetric_heat_capacity(
        theta_l, 0.0 if no_ice else theta_i, sp.rho_c_ds, param_set
    )
    if T is None:
        if no_ice:
            T = param_set.T_0 + rho_e_int / rho_c_s
        else:
            T = sh.temperature_from_rho_e_int(rho_e_int, theta_i, rho_c_s, param_set)
    kappa_dry = sh.k_dry(param_set, sp)
    if no_ice:
        S_r = sh.relative_saturation(theta_l, 0.0, sp.nu)
        kersten = sh.kersten_number(0.0, S_r, sp)
        kappa_sat = torch.where(
            theta_l < sw._eps_of(theta_l),
            0.0,
            sp.kappa_sat_unfrozen * torch.ones_like(theta_l),
        )
    else:
        S_r = sh.relative_saturation(theta_l, theta_i, sp.nu)
        kersten = sh.kersten_number(theta_i, S_r, sp)
        kappa_sat = sh.saturated_thermal_conductivity(
            theta_l, theta_i, sp.kappa_sat_unfrozen, sp.kappa_sat_frozen
        )
    kappa = sh.thermal_conductivity(kappa_dry, kersten, kappa_sat)
    return T, kappa, rho_c_s


def lateral_surface_tendency(model: SoilModel, h_top: Array, dz: Array) -> Array:
    """``(c / dz) * lap_xy(h_top)`` on the periodic 2-D column grid of
    ``h_top`` ``(nx, ny)``: the top cell's lateral surface coupling."""
    lc = model.lateral_coupling
    if h_top.dim() < 2:
        raise ValueError(
            "LateralSurfaceCoupling requires a 2-D (nx, ny) column batch; "
            f"got surface field of shape {tuple(h_top.shape)}"
        )
    lap = (
        torch.roll(h_top, 1, 0)
        + torch.roll(h_top, -1, 0)
        + torch.roll(h_top, 1, 1)
        + torch.roll(h_top, -1, 1)
        - 4.0 * h_top
    ) / (lc.dx * lc.dx)
    # c / dz rounds in the field's dtype, as the JAX package's does
    dz = torch.as_tensor(dz, dtype=h_top.dtype, device=h_top.device)
    return lc.conductance / dz * lap


def _add_lateral(model: SoilModel, d_vartheta_l: Array, h: Array, dz: Array) -> Array:
    """``d_vartheta_l`` with the lateral surface tendency added to the top
    cell (unchanged without lateral coupling)."""
    if model.lateral_coupling is None:
        return d_vartheta_l
    top = h.shape[0] - 1
    lateral = lateral_surface_tendency(model, h[top], dz)
    return torch.cat([d_vartheta_l[:top], (d_vartheta_l[top] + lateral)[None]], dim=0)


def _face_fluxes(model, grid, X, t, required=()):
    """Boundary fluxes at both faces; a ``required`` flux key missing
    (NoBC) at either face raises with the face and key."""
    bcs = model.boundary_conditions
    fluxes = {
        "bottom": boundary_fluxes(X, bcs.bottom, "bottom", model, grid, t),
        "top": boundary_fluxes(X, bcs.top, "top", model, grid, t),
    }
    for face, per_face in fluxes.items():
        for key in required:
            if per_face.get(key) is None:
                raise ValueError(
                    f"model with dynamic components requires a boundary "
                    f"condition producing '{key}' at the {face} face "
                    f"(got NoBC)"
                )
    return fluxes


# --------------------------------------------------------------------------
# make_rhs — 4-way dispatch
# --------------------------------------------------------------------------


def make_rhs(model: SoilModel, grid: ColumnGrid | None = None):
    """Build ``rhs(Y, Ya, t) -> dY`` for the model's component combination.
    The returned function first refreshes prescribed aux fields, then
    evaluates the tendencies."""
    if grid is None:
        grid = make_function_space(model.domain, model.float_dtype, model.device)
    update_aux_en = make_update_aux(model.energy_model)
    update_aux_hydr = make_update_aux(model.hydrology_model)
    rhs_soil = _make_rhs_soil(model.energy_model, model.hydrology_model, model, grid)

    def rhs(Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux_en(Ya, t, model.name)
        Ya = update_aux_hydr(Ya, t, model.name)
        return rhs_soil(Y, Ya, t)

    return rhs


def _make_rhs_soil(energy, hydrology, model: SoilModel, grid: ColumnGrid):
    name = model.name
    dz = grid.dz

    if isinstance(energy, PrescribedTemperatureModel) and isinstance(
        hydrology, PrescribedHydrologyModel
    ):

        def rhs(Y, Ya, t):
            return {name: {}} if name in Y else {}

        return rhs

    if isinstance(energy, PrescribedTemperatureModel) and isinstance(
        hydrology, SoilHydrologyModel
    ):

        def rhs(Y, Ya, t):
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
            T = torch.as_tensor(Ya[name]["T"]).expand(vartheta_l.shape)
            zc = Ya["zc"]

            theta_l, K, psi = hydrology_center_fields(model, vartheta_l, theta_i, T)
            h = psi + zc

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(model, grid, X, t, required=("f_vartheta_l",))

            water_flux = diffusive_flux_faces(K, h, dz)
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            d_vartheta_l = _add_lateral(model, d_vartheta_l, h, dz)
            return {
                name: {
                    "vartheta_l": d_vartheta_l,
                    "theta_i": torch.zeros_like(theta_i),
                }
            }

        return rhs

    if isinstance(energy, SoilEnergyModel) and isinstance(
        hydrology, PrescribedHydrologyModel
    ):

        def rhs(Y, Ya, t):
            rho_e_int = Y[name]["rho_e_int"]
            vartheta_l = torch.as_tensor(Ya[name]["vartheta_l"]).expand(rho_e_int.shape)
            theta_i = torch.as_tensor(Ya[name]["theta_i"]).expand(rho_e_int.shape)

            sp = model.soil_param_set
            nu_eff = sp.nu - theta_i
            theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
            T, kappa, _ = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=rho_e_int
            )

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(model, grid, X, t, required=("f_rho_e_int",))

            heat_flux = diffusive_flux_faces(kappa, T, dz)
            d_rho_e_int = -div_f2c(
                heat_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )
            return {name: {"rho_e_int": d_rho_e_int}}

        return rhs

    if isinstance(energy, SoilEnergyModel) and isinstance(hydrology, SoilHydrologyModel):

        def rhs(Y, Ya, t):
            vartheta_l = Y[name]["vartheta_l"]
            theta_i = Y[name]["theta_i"]
            rho_e_int = Y[name]["rho_e_int"]
            zc = Ya["zc"]

            sp = model.soil_param_set
            param_set = model.earth_param_set
            nu_eff = sp.nu - theta_i
            theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
            T, kappa, rho_c_s = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=rho_e_int
            )
            rho_e_int_l = sh.volumetric_internal_energy_liq(T, param_set)
            _, K, psi = hydrology_center_fields(model, vartheta_l, theta_i, T)
            h = psi + zc

            X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
            fluxes = _face_fluxes(
                model, grid, X, t, required=("f_vartheta_l", "f_rho_e_int")
            )

            water_flux = diffusive_flux_faces(K, h, dz)  # -K grad h on faces
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            d_vartheta_l = _add_lateral(model, d_vartheta_l, h, dz)
            # energy flux: -kappa grad T - rho_e_int_l K grad h
            energy_flux = diffusive_flux_faces(kappa, T, dz) + diffusive_flux_faces(
                rho_e_int_l * K, h, dz
            )
            d_rho_e_int = -div_f2c(
                energy_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )
            d_theta_i = torch.zeros_like(theta_i)
            if isinstance(model.freeze_thaw, FreezeThaw):
                src_l, src_i = phase_change_sources(
                    model.freeze_thaw,
                    model.hydrology_model.hydraulic_model,
                    theta_l,
                    theta_i,
                    T,
                    sp.nu,
                    rho_c_s,
                    param_set,
                )
                d_vartheta_l = d_vartheta_l + src_l
                d_theta_i = d_theta_i + src_i
            return {
                name: {
                    "vartheta_l": d_vartheta_l,
                    "theta_i": d_theta_i,
                    "rho_e_int": d_rho_e_int,
                }
            }

        return rhs

    raise TypeError(
        f"Unsupported component combination ({energy!r}, {hydrology!r})"
    )
