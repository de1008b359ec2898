"""Freeze-thaw phase change.

PyTorch port of ``landhydrology_tpu/models/soil/freeze_thaw.py``.  Two
configurations of the coupled column:

- :class:`FreezeThaw` relaxes toward the freezing-point-depression
  equilibrium at rate ``1/tau``: :func:`phase_change_sources` adds a
  (d vartheta_l/dt, d theta_i/dt) pair to the rhs.  Freezing and melting are
  energy-limited, so the diagnosed temperature relaxes to T_0 instead of
  chattering across it.
- :class:`EquilibriumFreezeThaw` is the tau -> 0 limit: every step ends with
  :func:`equilibrium_phase_projection`, a per-cell bisection on T at fixed
  water mass ``w = vartheta_l + (rho_i/rho_l) theta_i`` and fixed rho_e_int.

``rho_e_int`` needs no source: its definition books ``-theta_i rho_i LH_f0``,
so phase change at fixed rho_e_int moves the diagnosed temperature, and water
mass and energy are conserved identically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from landhydrology_tpu_torch.constants import EarthParameterSet
from landhydrology_tpu_torch.models.soil import water as sw

Array = Any


@dataclasses.dataclass(frozen=True)
class FreezeThaw:
    """Rate-based phase change with relaxation timescale ``tau`` (s); tau
    should resolve a few time steps."""

    tau: Array = 3600.0


@dataclasses.dataclass(frozen=True)
class EquilibriumFreezeThaw:
    """Instantaneous phase equilibrium: a projection after every step,
    ``n_iter`` bisection rounds on T in ``[T_lo, T_hi]``."""

    #: bisection iterations: 60 halvings of [T_lo, T_hi] reach ~1e-16 K
    n_iter: int = 60
    T_lo: float = 150.0
    T_hi: float = 350.0


def equilibrium_unfrozen_liquid(
    hm: sw.vanGenuchten, T: Array, nu: Array, param_set: EarthParameterSet
) -> Array:
    """Maximum unfrozen liquid fraction theta_l_max(T) from freezing-point
    depression (Clapeyron ``psi_f = LH_f0 (T - T_0) / (g T)`` through the
    inverse retention curve); +inf at and above T_0 (no constraint)."""
    T_0 = param_set.T_0
    T_safe = sw._maximum(T, 200.0)  # keeps the Clapeyron ratio finite
    psi_f = param_set.LH_f0 * (sw._minimum(T_safe, T_0) - T_0) / (
        param_set.grav * T_safe
    )
    S_max = sw.inverse_matric_potential(hm, psi_f)
    theta_l_max = hm.theta_r + (nu - hm.theta_r) * S_max
    return torch.where(T >= T_0, math.inf, theta_l_max)


def phase_change_sources(
    ft: FreezeThaw,
    hm: sw.vanGenuchten,
    theta_l: Array,
    theta_i: Array,
    T: Array,
    nu: Array,
    rho_c_s: Array,
    param_set: EarthParameterSet,
) -> tuple:
    """(d vartheta_l/dt, d theta_i/dt) phase-change source pair.  The amount
    frozen (melted) per relaxation time cannot release (absorb) more latent
    heat than would bring the cell to T_0."""
    rho_l = param_set.rho_cloud_liq
    rho_i = param_set.rho_cloud_ice
    L = param_set.LH_f0
    T_0 = param_set.T_0

    theta_l_max = equilibrium_unfrozen_liquid(hm, T, nu, param_set)
    excess = torch.where(
        torch.isinf(theta_l_max), 0.0, sw._maximum(theta_l - theta_l_max, 0.0)
    )
    # energy headroom to T_0, expressed as an ice-volume equivalent
    deficit_ice = sw._maximum(rho_c_s * (T_0 - T), 0.0) / (rho_i * L)
    surplus_ice = sw._maximum(rho_c_s * (T - T_0), 0.0) / (rho_i * L)

    freeze_ice = torch.minimum((rho_l / rho_i) * excess, deficit_ice) / ft.tau
    melt_ice = torch.minimum(theta_i, surplus_ice) / ft.tau

    d_theta_i = freeze_ice - melt_ice
    d_vartheta_l = (rho_i / rho_l) * (melt_ice - freeze_ice)
    return d_vartheta_l, d_theta_i


def equilibrium_phase_projection(model, Y: dict) -> dict:
    """Project every cell of the state onto phase equilibrium at fixed total
    water mass and fixed ``rho_e_int`` (see :class:`EquilibriumFreezeThaw`).
    Returns a new state; ``rho_e_int`` is carried over unchanged."""
    ft = model.freeze_thaw
    name = model.name
    sp = model.soil_param_set
    hm = model.hydrology_model.hydraulic_model
    param_set = model.earth_param_set
    rho_l = param_set.rho_cloud_liq
    rho_i = param_set.rho_cloud_ice
    L = param_set.LH_f0
    T_0 = param_set.T_0

    vartheta = Y[name]["vartheta_l"]
    theta_i = Y[name]["theta_i"]
    e = Y[name]["rho_e_int"]
    w = vartheta + (rho_i / rho_l) * theta_i  # liquid-volume-equivalent mass

    def partition(T):
        """(theta_l, theta_i) on the equilibrium manifold at temperature T."""
        tlm = equilibrium_unfrozen_liquid(hm, T, sp.nu, param_set)
        theta_l = torch.where(T >= T_0, w, torch.minimum(w, tlm))
        ti = (rho_l / rho_i) * (w - theta_l)
        return theta_l, ti

    def residual(T):
        theta_l, ti = partition(T)
        # rho_c_s uses the capped liquid fraction, as the rhs does
        theta_l_cap = sw._minimum(theta_l, sp.nu - ti)
        rho_c_s = (
            sp.rho_c_ds
            + theta_l_cap * param_set.rho_cp_l
            + ti * param_set.rho_cp_i
        )
        return rho_c_s * (T - T_0) - ti * rho_i * L - e

    lo = torch.full_like(e, ft.T_lo)
    hi = torch.full_like(e, ft.T_hi)
    f_lo = residual(lo)
    for _ in range(ft.n_iter):
        mid = 0.5 * (lo + hi)
        f_mid = residual(mid)
        same = f_mid * f_lo > 0.0
        lo, hi, f_lo = (
            torch.where(same, mid, lo),
            torch.where(same, hi, mid),
            torch.where(same, f_mid, f_lo),
        )
    T_eq = 0.5 * (lo + hi)
    theta_l_new, theta_i_new = partition(T_eq)
    return {
        **Y,
        name: {
            **Y[name],
            "vartheta_l": theta_l_new,
            "theta_i": sw._maximum(theta_i_new, 0.0),
        },
    }


@dataclasses.dataclass(frozen=True)
class PhaseEquilibriumStepper:
    """Stepper decorator: advance with ``inner``, then apply the equilibrium
    phase projection."""

    inner: Any
    model: Any

    @property
    def stages(self) -> int:
        return self.inner.stages

    @property
    def order(self) -> int:
        return getattr(self.inner, "order", 1)

    @property
    def unconditionally_stable(self) -> bool:
        return getattr(self.inner, "unconditionally_stable", False)

    def step(self, rhs, Y, Ya, t, dt):
        Y2 = self.inner.step(rhs, Y, Ya, t, dt)
        return equilibrium_phase_projection(self.model, Y2)


def wrap_stepper_with_projection(stepper, model):
    """Wrap ``stepper`` with the equilibrium projection when the model uses
    :class:`EquilibriumFreezeThaw` (idempotent; no-op otherwise)."""
    if isinstance(model.freeze_thaw, EquilibriumFreezeThaw) and not isinstance(
        stepper, PhaseEquilibriumStepper
    ):
        return PhaseEquilibriumStepper(inner=stepper, model=model)
    return stepper
