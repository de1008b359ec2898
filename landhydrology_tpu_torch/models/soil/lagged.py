"""Lagged-coefficient stepping: ``SoilModel(coefficient_update="step")``.

PyTorch port of ``landhydrology_tpu/models/soil/lagged.py``.  The nonlinear
coefficients (hydraulic conductivity K, thermal conductivity kappa, the heat
capacity rho_c_s and its reciprocal, and the advected-energy product
rho_e_int_l K) are evaluated once per time step, at the step's initial
state, and held fixed across the RK stages.  Each stage recomputes only the
pressure head, the temperature through the frozen heat capacity, the
stencils and the boundary fluxes.  The deviation from stage-level semantics
is first order in dt; the rhs stays in flux form, so mass and energy totals
close identically.  A lateral surface coupling stays live per stage, as
in the stage rhs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from landhydrology_tpu_torch.domains import ColumnGrid, make_function_space
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    FreezeThaw,
    phase_change_sources,
)
from landhydrology_tpu_torch.models.soil.model import (
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.rhs import (
    _add_lateral,
    _face_fluxes,
    energy_center_fields,
    hydrology_center_fields,
    make_update_aux,
)
from landhydrology_tpu_torch.ops.stencil import diffusive_flux_faces, div_f2c

Array = Any


def make_coefficient_fns(model: SoilModel, grid: ColumnGrid | None = None):
    """``(compute_coeffs, rhs_with_coeffs)`` for the model's component
    combination:

    - ``compute_coeffs(Y, Ya, t) -> C`` evaluates the laggable coefficient
      fields at a state;
    - ``rhs_with_coeffs(C, Y, Ya, t) -> dY`` is the tendency with those
      coefficients held fixed.

    ``rhs_with_coeffs(compute_coeffs(Y, Ya, t), Y, Ya, t)`` differs from
    ``make_rhs(model)(Y, Ya, t)`` only in rounding: the temperature is
    diagnosed by multiplying with the stored reciprocal heat capacity.
    """
    if grid is None:
        grid = make_function_space(model.domain, model.float_dtype, model.device)
    name = model.name
    dz = grid.dz
    sp = model.soil_param_set
    param_set = model.earth_param_set
    energy = model.energy_model
    hydrology = model.hydrology_model
    update_aux_en = make_update_aux(energy)
    update_aux_hydr = make_update_aux(hydrology)

    def update_aux(Ya, t):
        Ya = update_aux_en(Ya, t, name)
        return update_aux_hydr(Ya, t, name)

    dyn_energy = isinstance(energy, SoilEnergyModel)
    dyn_hydrology = isinstance(hydrology, SoilHydrologyModel)
    no_ice = model.assume_no_ice
    rate_freeze = isinstance(model.freeze_thaw, FreezeThaw)

    if not dyn_energy and not dyn_hydrology:
        raise ValueError(
            "coefficient_update='step' requires at least one dynamic "
            "component (the fully prescribed model has no coefficients to "
            "lag)"
        )

    def water_fields(Y, Ya):
        if dyn_hydrology:
            return Y[name]["vartheta_l"], Y[name]["theta_i"]
        shape = Y[name]["rho_e_int"].shape
        return (
            torch.as_tensor(Ya[name]["vartheta_l"]).expand(shape),
            torch.as_tensor(Ya[name]["theta_i"]).expand(shape),
        )

    # --- the laggable coefficient sweep (once per step) ---

    def compute_coeffs(Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux(Ya, t)
        vartheta_l, theta_i = water_fields(Y, Ya)
        nu_eff = sp.nu if no_ice else sp.nu - theta_i
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
        C: dict = {}
        if dyn_energy:
            T, kappa, rho_c_s = energy_center_fields(
                model, theta_l, theta_i, rho_e_int=Y[name]["rho_e_int"]
            )
            C["kappa"] = kappa
            C["rho_c_s"] = rho_c_s
            C["inv_rho_c_s"] = 1.0 / rho_c_s
        else:
            T = torch.as_tensor(Ya[name]["T"]).expand(vartheta_l.shape)
        if dyn_hydrology:
            _, K, _ = hydrology_center_fields(model, vartheta_l, theta_i, T)
            C["K"] = K
            if dyn_energy:
                # the advected-energy coefficient is lagged as the product
                C["KE"] = sh.volumetric_internal_energy_liq(T, param_set) * K
        return C

    # --- the per-stage tendency with frozen coefficients ---

    def diagnose_T(C, rho_e_int, theta_i):
        """T through the FROZEN heat capacity (reciprocal-multiply); the
        latent-heat offset stays live with theta_i."""
        if no_ice:
            return param_set.T_0 + rho_e_int * C["inv_rho_c_s"]
        return param_set.T_0 + (
            rho_e_int + theta_i * param_set.rho_cloud_ice * param_set.LH_f0
        ) * C["inv_rho_c_s"]

    def rhs_with_coeffs(C: dict, Y: dict, Ya: dict, t: Array) -> dict:
        Ya = update_aux(Ya, t)
        zc = Ya["zc"]
        out: dict = {}
        vartheta_l, theta_i = water_fields(Y, Ya)
        if dyn_energy:
            T = diagnose_T(C, Y[name]["rho_e_int"], theta_i)
        else:
            T = torch.as_tensor(Ya[name]["T"]).expand(vartheta_l.shape)

        # the boundary fluxes are not lagged: they see the stage state
        X = {"vartheta_l": vartheta_l, "theta_i": theta_i, "T": T}
        required = ()
        if dyn_hydrology:
            required += ("f_vartheta_l",)
        if dyn_energy:
            required += ("f_rho_e_int",)
        fluxes = _face_fluxes(model, grid, X, t, required=required)

        if dyn_hydrology:
            nu_eff = sp.nu if no_ice else sp.nu - theta_i
            psi = sw.pressure_head(hydrology.hydraulic_model, vartheta_l, nu_eff, sp.S_s)
            h = psi + zc
            water_flux = diffusive_flux_faces(C["K"], h, dz)
            d_vartheta_l = -div_f2c(
                water_flux,
                fluxes["bottom"]["f_vartheta_l"],
                fluxes["top"]["f_vartheta_l"],
                dz,
            )
            out["vartheta_l"] = _add_lateral(model, d_vartheta_l, h, dz)
            out["theta_i"] = torch.zeros_like(theta_i)

        if dyn_energy:
            energy_flux = diffusive_flux_faces(C["kappa"], T, dz)
            if dyn_hydrology:
                energy_flux = energy_flux + diffusive_flux_faces(C["KE"], h, dz)
            out["rho_e_int"] = -div_f2c(
                energy_flux,
                fluxes["bottom"]["f_rho_e_int"],
                fluxes["top"]["f_rho_e_int"],
                dz,
            )

        # freeze-thaw rate sources stay live per stage (they are the phase
        # dynamics, not a coefficient); only rho_c_s inside them is frozen
        if rate_freeze:
            theta_l = sw.volumetric_liquid_fraction(vartheta_l, sp.nu - theta_i)
            src_l, src_i = phase_change_sources(
                model.freeze_thaw,
                hydrology.hydraulic_model,
                theta_l,
                theta_i,
                T,
                sp.nu,
                C["rho_c_s"],
                param_set,
            )
            out["vartheta_l"] = out["vartheta_l"] + src_l
            out["theta_i"] = out["theta_i"] + src_i

        return {name: out}

    return compute_coeffs, rhs_with_coeffs


@dataclasses.dataclass(frozen=True)
class LaggedCoefficientStepper:
    """Stepper decorator realizing ``SoilModel(coefficient_update="step")``:
    evaluate the coefficient sweep once at the step's initial state and drive
    the inner stepper with the frozen-coefficient rhs.  The ``rhs`` argument
    of :meth:`step` is ignored, so no stage-level coefficient sweep can sneak
    back in."""

    inner: Any
    model: Any
    grid: Any = None

    @property
    def stages(self) -> int:
        return getattr(self.inner, "stages", 1)

    @property
    def order(self) -> int:
        return getattr(self.inner, "order", 1)

    @property
    def unconditionally_stable(self) -> bool:
        return getattr(self.inner, "unconditionally_stable", False)

    def step(self, rhs, Y, Ya, t, dt):
        compute_coeffs, rhs_c = make_coefficient_fns(self.model, self.grid)
        C = compute_coeffs(Y, Ya, t)

        def frozen_rhs(Y_, Ya_, t_):
            return rhs_c(C, Y_, Ya_, t_)

        return self.inner.step(frozen_rhs, Y, Ya, t, dt)


def _chain_contains(stepper, cls) -> bool:
    st = stepper
    while st is not None:
        if isinstance(st, cls):
            return True
        st = getattr(st, "inner", None)
    return False


def wrap_stepper_for_soil(stepper, model, grid=None):
    """Apply a SoilModel's coefficient-update policy to a stepper
    (idempotent; no-op for ``coefficient_update="stage"`` and for other
    models)."""
    if (
        isinstance(model, SoilModel)
        and model.coefficient_update == "step"
        and not _chain_contains(stepper, LaggedCoefficientStepper)
    ):
        return LaggedCoefficientStepper(inner=stepper, model=model, grid=grid)
    return stepper
