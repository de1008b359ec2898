"""Implicit vertical solver: backward Euler and TR-BDF2 for the stiff
diffusion.

PyTorch port of ``landhydrology_tpu/imex.py``.  Columns are independent, so
each implicit update is a batched per-column tridiagonal solve
(``ops/tridiag.py``).  Each stage equation ``u = c + w f(u)`` is solved by
frozen-coefficient Newton sweeps

    (I - w A) delta = c - u^m + w f(u^m),   u^{m+1} = u^m + delta,

with ``f`` the exact rhs (boundary fluxes included, so the fixed point is
exact) and ``A`` the linearized vertical diffusion

    (A delta)_i = [K_{i+1/2}(C_{i+1} d_{i+1} - C_i d_i)
                   - K_{i-1/2}(C_i d_i - C_{i-1} d_{i-1})] / dz^2,

``C = d psi / d vartheta_l`` for water (``water.dpsi_dtheta``, the closed
form of the JAX package's ``jax.grad``) and ``1/rho_c_s`` for heat.
Dirichlet faces add a diagonal boost; the water update is clamped to half
the porosity (trust region).

- :class:`BackwardEulerRichards`: implicit water, the other variables
  explicit (first order);
- :class:`BackwardEulerSoil`: implicit water, then implicit heat;
- :class:`TRBDF2Soil`: the L-stable second-order TR-BDF2 step, water and/or
  heat, for every dynamic branch.

Each stepper names the times at which it evaluates the rhs
(``stage_times``); the CUDA kernel's BC and profile tables are built at
exactly those times.  ``engine="fused"`` runs the three steppers in
``csrc/implicit_kernel.cu`` (kernel mode B4).

Heat-only models: the JAX package's ``_heat_newton_sweep`` reads
``vartheta_l``/``theta_i`` from the state, which a heat-only model does not
have, so its TR-BDF2 raises ``KeyError`` there although its docstring lists
the branch.  Here the sweep takes them from the prescribed profiles at the
stage time, as the heat-only rhs does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from landhydrology_tpu_torch.domains import ColumnGrid
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.boundary import Dirichlet, _value_at
from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw
from landhydrology_tpu_torch.models.soil.model import (
    PrescribedHydrologyModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.rhs import energy_center_fields, make_update_aux
from landhydrology_tpu_torch.ops.stencil import interp_c2f_interior
from landhydrology_tpu_torch.ops.tridiag import pcr_solve, thomas_solve
from landhydrology_tpu_torch.timestepping import AbstractTimestepper

Array = Any


def _spacing(grid: ColumnGrid, like: Array) -> tuple:
    """``(dz, dz/2)`` as tensors of ``like``'s dtype, so products of the
    spacing round in the model dtype as the JAX grid's do."""
    dz = torch.as_tensor(grid.dz, dtype=like.dtype, device=like.device)
    return dz, dz / 2.0


def _backward_euler_delta(
    K: Array,
    C: Array,
    b: Array,
    dt: Array,
    grid: ColumnGrid,
    diag_boost_bot: Array = 0.0,
    diag_boost_top: Array = 0.0,
    solver: str = "thomas",
) -> Array:
    """Solve ``(I - dt A) delta = b`` for the frozen-coefficient diffusion
    linearization with center coefficient ``K`` (interpolated to faces, zero
    at the boundary faces) and pointwise state derivative ``C``;
    ``diag_boost_*`` add the Dirichlet boundary-face diagonal terms."""
    nz = K.shape[0]
    if nz == 1:
        # single cell: no interior face, the system is diagonal
        d = 1.0 - dt * (diag_boost_bot + diag_boost_top)
        return b / d
    Kf = interp_c2f_interior(K)
    zeros = torch.zeros_like(K[0:1])
    K_minus = torch.cat([zeros, Kf], dim=0)  # face below cell i
    K_plus = torch.cat([Kf, zeros], dim=0)  # face above cell i

    dz, _ = _spacing(grid, K)
    inv_dz2 = 1.0 / (dz * dz)
    diag_A = -(K_minus + K_plus) * C * inv_dz2
    # the wrap rows multiply the zero boundary faces
    C_down = torch.cat([C[0:1], C[0 : nz - 1]], dim=0)  # C[i-1]
    C_up = torch.cat([C[1:nz], C[nz - 1 : nz]], dim=0)  # C[i+1]
    sub_A = K_minus * C_down * inv_dz2
    sup_A = K_plus * C_up * inv_dz2
    diag_A = torch.cat(
        [diag_A[0:1] + diag_boost_bot, diag_A[1 : nz - 1], diag_A[nz - 1 : nz] + diag_boost_top],
        dim=0,
    )

    dl = -dt * sub_A
    d = 1.0 - dt * diag_A
    du = -dt * sup_A
    if solver == "pcr":
        return pcr_solve(dl, d, du, b)
    if solver != "thomas":
        raise ValueError(f"unknown tridiagonal solver {solver!r}")
    return thomas_solve(dl, d, du, b)


def _water_newton_sweep(
    model, grid, rhs, Ybase: dict, Ya: dict, v_m: Array,
    c_const: Array, w: Array, t_eval: Array, solver: str = "thomas",
) -> Array:
    """One frozen-coefficient Newton update of the water stage equation
    ``v = c_const + w f_w(v)`` (the other variables frozen at ``Ybase``)."""
    name = model.name
    hydrology = model.hydrology_model
    hm = hydrology.hydraulic_model
    sp = model.soil_param_set
    ps = model.earth_param_set
    theta_i = Ybase[name]["theta_i"]

    Ym = {name: dict(Ybase[name], vartheta_l=v_m)}
    f = rhs(Ym, Ya, t_eval)[name]["vartheta_l"]

    # frozen coefficients at the current iterate
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(v_m, nu_eff)
    f_i = sw.ice_fraction_of_water(theta_l, theta_i)
    if isinstance(hydrology.viscosity_factor, sw.TemperatureDependentViscosity):
        if "rho_e_int" in Ybase[name]:
            rho_c_s = sh.volumetric_heat_capacity(theta_l, theta_i, sp.rho_c_ds, ps)
            T = sh.temperature_from_rho_e_int(Ybase[name]["rho_e_int"], theta_i, rho_c_s, ps)
        else:
            T = torch.as_tensor(Ya[name]["T"]).expand(v_m.shape)
    else:
        T = torch.ones_like(v_m)  # NoEffect: the value is irrelevant
    visc = sw.viscosity_factor(hydrology.viscosity_factor, T)
    imp = sw.impedance_factor(hydrology.impedance_factor, f_i)
    S = sw.effective_saturation(sp.nu, v_m, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, visc, imp)
    C = sw.dpsi_dtheta(hm, v_m, nu_eff, sp.S_s)

    # Dirichlet faces: the diagonal term -K_face C_i / (dz_half dz), with
    # K_face at the Dirichlet value and unit viscosity and impedance factors
    def k_at_value(v_dir):
        S_f = sw.effective_saturation(sp.nu, v_dir, hm.theta_r)
        return sw.hydraulic_conductivity(hm, S_f, torch.ones_like(S_f), torch.ones_like(S_f))

    bcs = model.boundary_conditions
    dz, dz_half = _spacing(grid, v_m)
    top = v_m.shape[0] - 1
    boost_bot = boost_top = 0.0
    bc_bot = getattr(bcs.bottom, "hydrology", None)
    bc_top = getattr(bcs.top, "hydrology", None)
    if isinstance(bc_bot, Dirichlet):
        K_f = k_at_value(_value_at(bc_bot.state_value, t_eval, v_m))
        boost_bot = -K_f * C[0] / (dz_half * dz)
    if isinstance(bc_top, Dirichlet):
        K_f = k_at_value(_value_at(bc_top.state_value, t_eval, v_m))
        boost_top = -K_f * C[top] / (dz_half * dz)

    b = c_const - v_m + w * f
    delta = _backward_euler_delta(K, C, b, w, grid, boost_bot, boost_top, solver=solver)
    # trust region: at most half the column's porosity per update
    lim = 0.5 * sp.nu
    delta = sw._clip(delta, -lim, lim)
    return v_m + delta


def _heat_newton_sweep(
    model, grid, rhs, Ybase: dict, Ya: dict, e_m: Array,
    c_const: Array, w: Array, t_eval: Array, solver: str = "thomas",
) -> Array:
    """One frozen-coefficient Newton update of the heat stage equation
    ``e = c_const + w f_e(e)`` (water and ice frozen at ``Ybase``, or at the
    prescribed profiles at ``t_eval`` in a heat-only model); exact for pure
    conduction in one sweep."""
    name = model.name
    sp = model.soil_param_set
    if isinstance(model.hydrology_model, PrescribedHydrologyModel):
        aux = make_update_aux(model.hydrology_model)(Ya, t_eval, name)[name]
        theta_i = torch.as_tensor(aux["theta_i"]).expand(e_m.shape)
        v_base = torch.as_tensor(aux["vartheta_l"]).expand(e_m.shape)
    else:
        theta_i = Ybase[name]["theta_i"]
        v_base = Ybase[name]["vartheta_l"]
    theta_l = sw.volumetric_liquid_fraction(v_base, sp.nu - theta_i)

    Ym = {name: dict(Ybase[name], rho_e_int=e_m)}
    f = rhs(Ym, Ya, t_eval)[name]["rho_e_int"]
    _, kappa, rho_c_s = energy_center_fields(model, theta_l, theta_i, rho_e_int=e_m)
    C = 1.0 / rho_c_s  # dT / d rho_e_int

    bcs = model.boundary_conditions
    dz, dz_half = _spacing(grid, e_m)
    top = e_m.shape[0] - 1
    boost_bot = boost_top = 0.0
    if isinstance(getattr(bcs.bottom, "energy", None), Dirichlet):
        boost_bot = -kappa[0] * C[0] / (dz_half * dz)
    if isinstance(getattr(bcs.top, "energy", None), Dirichlet):
        boost_top = -kappa[top] * C[top] / (dz_half * dz)

    b = c_const - e_m + w * f
    delta = _backward_euler_delta(kappa, C, b, w, grid, boost_bot, boost_top, solver=solver)
    return e_m + delta


@dataclasses.dataclass(frozen=True)
class BackwardEulerRichards(AbstractTimestepper):
    """Backward Euler for ``vartheta_l`` with ``iters`` frozen-coefficient
    Newton sweeps; any other prognostic variable is advanced explicitly with
    its tendency at the new water state (IMEX splitting).  ``tridiag`` is
    ``"thomas"`` or ``"pcr"``."""

    model: SoilModel
    grid: ColumnGrid
    iters: int = 2
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 1

    @property
    def stages(self) -> int:
        return self.iters

    def stage_times(self, t: Array, dt: Array) -> tuple:
        """The times of the step's rhs evaluations: all at ``t + dt``."""
        return (t + dt,)

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        v_new = self.water_solve(rhs, Y, Ya, t, dt)
        name = self.model.name
        (t_new,) = self.stage_times(t, dt)
        out = dict(Y[name], vartheta_l=v_new)
        if "rho_e_int" in Y[name] or "theta_i" in Y[name]:
            Ym = {name: dict(Y[name], vartheta_l=v_new)}
            f_all = rhs(Ym, Ya, t_new)[name]
            for k in Y[name]:
                if k != "vartheta_l":
                    out[k] = Y[name][k] + dt * f_all[k]
        return {name: out}

    def water_solve(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> Array:
        """The implicit Newton update of ``vartheta_l`` alone (shared with
        :class:`BackwardEulerSoil`)."""
        model, grid = self.model, self.grid
        if not isinstance(model.hydrology_model, SoilHydrologyModel):
            raise TypeError("BackwardEulerRichards needs a dynamic hydrology model")
        (t_new,) = self.stage_times(t, dt)
        v_n = Y[model.name]["vartheta_l"]
        v_new = v_n
        for _ in range(self.iters):
            v_new = _water_newton_sweep(
                model, grid, rhs, Y, Ya, v_new, v_n, dt, t_new, solver=self.tridiag
            )
        return v_new


@dataclasses.dataclass(frozen=True)
class BackwardEulerSoil(AbstractTimestepper):
    """Operator-split backward Euler for the coupled model: the water update
    of :class:`BackwardEulerRichards`, then ``iters`` heat sweeps with the
    new water field (exact for the conduction term; the advective energy
    flux rides the rhs).  First order."""

    model: SoilModel
    grid: ColumnGrid
    iters: int = 2
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 1

    def stage_times(self, t: Array, dt: Array) -> tuple:
        """The times of the step's rhs evaluations: all at ``t + dt``."""
        return (t + dt,)

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        model, grid = self.model, self.grid
        name = model.name
        if not isinstance(model.energy_model, SoilEnergyModel):
            raise TypeError("BackwardEulerSoil needs a dynamic energy model")
        water = BackwardEulerRichards(model=model, grid=grid, iters=self.iters, tridiag=self.tridiag)
        v_new = water.water_solve(rhs, Y, Ya, t, dt)

        (t_new,) = self.stage_times(t, dt)
        e_n = Y[name]["rho_e_int"]
        Ybase = {name: dict(Y[name], vartheta_l=v_new)}
        e_new = e_n
        for _ in range(self.iters):
            e_new = _heat_newton_sweep(
                model, grid, rhs, Ybase, Ya, e_new, e_n, dt, t_new, solver=self.tridiag
            )
        out = dict(Y[name], vartheta_l=v_new, rho_e_int=e_new)
        if model.freeze_thaw is not None:
            # the phase-change source, explicit on the updated state
            d = rhs({name: dict(out)}, Ya, t_new)[name]
            out["theta_i"] = Y[name]["theta_i"] + dt * d["theta_i"]
        return {name: out}


#: TR-BDF2 stage fraction gamma = 2 - sqrt(2) (the L-stable choice)
_TRBDF2_GAMMA = 2.0 - 2.0**0.5


def trbdf2_coefficients() -> dict:
    """TR-BDF2's constants as Python doubles: ``g`` (stage fraction), the
    TR weight ``half_g = g/2``, and the BDF2 combination ``a1``, ``a2`` and
    weight ``b``; each is rounded to the model dtype where it meets a
    tensor."""
    g = _TRBDF2_GAMMA
    d = 2.0 - g
    return {
        "g": g,
        "half_g": 0.5 * g,
        "a1": 1.0 / (g * d),
        "a2": -((1.0 - g) ** 2) / (g * d),
        "b": (1.0 - g) / d,
    }


@dataclasses.dataclass(frozen=True)
class TRBDF2Soil(AbstractTimestepper):
    """Second-order, L-stable TR-BDF2 step (Bank et al. 1985) with
    gamma = 2 - sqrt(2):

        TR   stage:  u* = u^n + (g dt/2) [f(u^n) + f(u*)]
        BDF2 stage:  u+ = a1 u* + a2 u^n + b dt f(u+)

    Each stage equation ``u = c + w f(u)`` is solved by ``iters``
    Gauss-Seidel sweeps of the Newton updates: water, then heat, then
    theta_i (a fixed point with ``FreezeThaw`` rate sources, else
    ``theta_i = c``).  Water-only, heat-only or coupled."""

    model: SoilModel
    grid: ColumnGrid
    iters: int = 3
    tridiag: str = "thomas"
    unconditionally_stable = True
    order = 2

    @property
    def stages(self) -> int:
        """rhs evaluations per step: ``f(u^n)``, then in each of the two
        stages ``iters`` sweeps of one evaluation per active component
        (water, heat, and the rate freeze-thaw fixed point)."""
        n_active = int(isinstance(self.model.hydrology_model, SoilHydrologyModel)) + int(
            isinstance(self.model.energy_model, SoilEnergyModel)
        )
        if self.model.freeze_thaw is not None and not isinstance(
            self.model.freeze_thaw, EquilibriumFreezeThaw
        ):
            n_active += 1
        return 1 + 2 * self.iters * max(n_active, 1)

    def stage_times(self, t: Array, dt: Array) -> tuple:
        """The times of the step's rhs evaluations: ``f(u^n)`` at ``t``, the
        TR stage at ``t + g dt``, the BDF2 stage at ``t + dt``."""
        return (t, t + _TRBDF2_GAMMA * dt, t + dt)

    def step(self, rhs, Y: dict, Ya: dict, t: Array, dt: Array) -> dict:
        model = self.model
        name = model.name
        k = trbdf2_coefficients()
        water = isinstance(model.hydrology_model, SoilHydrologyModel)
        heat = isinstance(model.energy_model, SoilEnergyModel)
        if not (water or heat):
            raise TypeError(
                "TRBDF2Soil needs at least one dynamic component "
                "(SoilHydrologyModel and/or SoilEnergyModel)"
            )
        t_n, t_tr, t_bdf2 = self.stage_times(t, dt)
        f_n = rhs(Y, Ya, t_n)[name]
        u_n = Y[name]

        w1 = k["half_g"] * dt
        c1 = {v: u_n[v] + w1 * f_n[v] for v in u_n}
        u_star = self._solve_stage(rhs, Ya, u_n, c1, w1, t_tr, water, heat)

        w2 = k["b"] * dt
        c2 = {v: k["a1"] * u_star[v] + k["a2"] * u_n[v] for v in u_n}
        u_new = self._solve_stage(rhs, Ya, u_star, c2, w2, t_bdf2, water, heat)
        return {name: u_new}

    def _solve_stage(self, rhs, Ya, init: dict, c: dict, w, t_eval, water: bool, heat: bool) -> dict:
        """Solve ``u = c + w f(u)`` by ``iters`` Gauss-Seidel sweeps."""
        model, grid = self.model, self.grid
        name = model.name
        has_ft = model.freeze_thaw is not None and not isinstance(
            model.freeze_thaw, EquilibriumFreezeThaw
        )
        st = dict(init)
        for _ in range(self.iters):
            if water:
                v = _water_newton_sweep(
                    model, grid, rhs, {name: st}, Ya, st["vartheta_l"], c["vartheta_l"],
                    w, t_eval, solver=self.tridiag,
                )
                st = dict(st, vartheta_l=v)
            if heat:
                e = _heat_newton_sweep(
                    model, grid, rhs, {name: st}, Ya, st["rho_e_int"], c["rho_e_int"],
                    w, t_eval, solver=self.tridiag,
                )
                st = dict(st, rho_e_int=e)
            if has_ft and "theta_i" in st:
                # the phase-change source: a fixed point of its stage equation
                f_ti = rhs({name: st}, Ya, t_eval)[name]["theta_i"]
                st = dict(st, theta_i=c["theta_i"] + w * f_ti)
            elif "theta_i" in st:
                # zero tendency: the stage equation is theta_i = c exactly
                st = dict(st, theta_i=c["theta_i"])
        return st


#: the implicit steppers, by the JAX package's class names
IMPLICIT_STEPPERS = (BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil)
