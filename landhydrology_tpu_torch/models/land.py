"""LandModel: soil column + ponded surface-water store.

PyTorch port of ``landhydrology_tpu/models/land.py``.  ``SurfaceWaterModel``
holds a prognostic pond height ``h_s`` (m) per column, fed by a prescribed
rain rate P(t) and drained into the soil at the infiltration rate

    I = min(P + h_s / tau_pond, f_pot),

with ``f_pot`` the potential (saturated-surface Dirichlet) downward flux at
the top face.  Under a ``PrescribedAtmosForcing`` top, one MOST solve over
the blended pond/bare-soil surface gives the evaporation of both and the
surface heat flux.  ``LandModel`` composes the soil and the store into one
state ``{"soil": {...}, "surface": {"h_s": ...}}`` with one rhs; both sides
of the component boundary consume the same exchange rates, so
d/dt [column water + h_s] = P - evaporation - bottom outflow holds
identically.  Optional lateral routing of the pond (``RunoffRouting``,
``KinematicWaveRouting``) needs a 2-D column grid and runs on the eager
engine only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from landhydrology_tpu_torch.domains import ColumnGrid, make_function_space
from landhydrology_tpu_torch.models.base import AbstractModel
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.boundary import (
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
    _dirichlet_hydrology_flux,
    initialize_boundary_values,
)
from landhydrology_tpu_torch.models.soil.model import (
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.rhs import make_rhs as make_soil_rhs

Array = Any

_NEGATIVE_RAIN = (
    "SurfaceWaterModel.precipitation must return a non-negative rainfall rate "
    "(m/s); got a negative value — do not use the signed downward-flux "
    "convention here"
)


def check_rain(value, on_card: bool = False) -> None:
    """Raise on a negative rain rate held on the host (a Python number or a
    CPU tensor), and with ``on_card`` on one held on the card too (a
    device sync: done once, where a rate is declared or tabulated)."""
    if torch.is_tensor(value):
        if (on_card or value.device.type == "cpu") and bool(torch.any(value < 0)):
            raise ValueError(_NEGATIVE_RAIN)
    elif value < 0:
        raise ValueError(_NEGATIVE_RAIN)


def _rate(rate):
    """A rain rate as a tensor; Python numbers in float64, as the JAX
    package holds them before the model's dtype is applied."""
    return rate if torch.is_tensor(rate) else torch.tensor(rate, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class ConstantPrecipitation:
    """Declarative constant rain rate (m/s); a call with a ``(n,)`` tensor
    of times gives the rate at each (broadcastable)."""

    rate: Array = 0.0

    def __post_init__(self):
        check_rain(self.rate, on_card=True)

    def __call__(self, t):
        return _rate(self.rate)


@dataclasses.dataclass(frozen=True)
class PulsePrecipitation:
    """Declarative rain pulse: ``rate`` for ``t_start <= t < t_stop``, dry
    otherwise; ``t`` may be a ``(n,)`` tensor of times."""

    rate: Array = 1e-6
    t_start: Array = 0.0
    t_stop: Array = 3600.0

    def __post_init__(self):
        check_rain(self.rate, on_card=True)

    def __call__(self, t):
        t = t if torch.is_tensor(t) else torch.tensor(t, dtype=torch.float64)
        on = (t >= self.t_start) & (t < self.t_stop)
        return torch.where(on, _rate(self.rate), 0.0)


@dataclasses.dataclass(frozen=True)
class RunoffRouting:
    """Diffusive lateral routing of the pond excess above ``h_detention``
    on the periodic 2-D column grid:
    dh_s/dt += conductance * lap_xy(max(h_s - h_detention, 0)) / dx^2."""

    conductance: Array = 1e-2  # m^2/s
    dx: Array = 1.0  # m
    h_detention: Array = 0.0  # m


@dataclasses.dataclass(frozen=True)
class KinematicWaveRouting:
    """Manning kinematic/diffusive-wave overland flow over the terrain
    ``elevation`` (``(nx, ny)`` tensor or scalar) on the periodic 2-D column
    grid: upwinded face discharges ``sign(s) sqrt|s| h_up^(5/3) / n``, with
    the slope of the water surface (``water_surface_slope``) or of the bed."""

    elevation: Array = 0.0
    manning_n: Array = 0.05  # s / m^(1/3)
    dx: Array = 1.0
    h_detention: Array = 0.0
    water_surface_slope: bool = True


def _manning_face_flux(s: Array, h_up: Array, manning_n) -> Array:
    """Upwinded Manning unit-width discharge through a face (m^2/s,
    positive downslope); the zero-slope branch is masked with a clamped
    operand."""
    flowing = torch.abs(s) > 0.0
    s_safe = torch.where(flowing, torch.abs(s), 1.0)
    return torch.where(
        flowing, torch.sign(s) * torch.sqrt(s_safe) * h_up ** (5.0 / 3.0) / manning_n, 0.0
    )


def _surface_heights(ro, h_s):
    h_eff = sw._maximum(h_s - ro.h_detention, 0.0)
    z = torch.as_tensor(ro.elevation, dtype=h_s.dtype, device=h_s.device).expand(h_s.shape)
    return h_eff, (z + h_eff if ro.water_surface_slope else z)


def _kinematic_wave_tendency(ro: KinematicWaveRouting, h_s: Array) -> Array:
    """dh_s/dt from upwinded Manning face fluxes in both lateral axes."""
    h_eff, w = _surface_heights(ro, h_s)
    dh = torch.zeros_like(h_s)
    for axis in (0, 1):
        w_dn = torch.roll(w, -1, dims=axis)
        s = (w - w_dn) / ro.dx
        h_up = torch.where(s > 0.0, h_eff, torch.roll(h_eff, -1, dims=axis))
        q = _manning_face_flux(s, h_up, ro.manning_n)
        dh = dh - (q - torch.roll(q, 1, dims=axis)) / ro.dx
    return dh


def _diffusive_routing_tendency(ro: RunoffRouting, h_s: Array) -> Array:
    """dh_s/dt from head diffusion of the pond excess (5-point Laplacian)."""
    h_eff = sw._maximum(h_s - ro.h_detention, 0.0)
    lap = (
        torch.roll(h_eff, 1, dims=0)
        + torch.roll(h_eff, -1, dims=0)
        + torch.roll(h_eff, 1, dims=1)
        + torch.roll(h_eff, -1, dims=1)
        - 4.0 * h_eff
    ) / (ro.dx * ro.dx)
    return ro.conductance * lap


def kinematic_wave_dt_limit(ro: KinematicWaveRouting, h_s: Array) -> Array:
    """Explicit-stability dt estimate ``dx / max c`` of the kinematic wave,
    ``c = (5/3) h^(2/3) sqrt|s| / n`` at every face."""
    h_eff, w = _surface_heights(ro, h_s)
    c_max = torch.zeros((), dtype=h_s.dtype, device=h_s.device)
    for axis in (0, 1):
        s = torch.abs(w - torch.roll(w, -1, dims=axis)) / ro.dx
        h_face = torch.maximum(h_eff, torch.roll(h_eff, -1, dims=axis))
        c = (5.0 / 3.0) * h_face ** (2.0 / 3.0) * torch.sqrt(s) / ro.manning_n
        c_max = torch.maximum(c_max, torch.max(c))
    return ro.dx / sw._maximum(c_max, 1e-30)


def routing_tendency(ro, h_s: Array) -> Array:
    """Lateral pond-routing tendency for any routing configuration."""
    if h_s.dim() < 2:
        raise ValueError(
            "runoff routing requires a 2-D (nx, ny) column grid; "
            f"got pond field of shape {tuple(h_s.shape)}"
        )
    if isinstance(ro, KinematicWaveRouting):
        return _kinematic_wave_tendency(ro, h_s)
    if isinstance(ro, RunoffRouting):
        return _diffusive_routing_tendency(ro, h_s)
    raise TypeError(f"unknown runoff routing config {ro!r}")


@dataclasses.dataclass(frozen=True)
class SurfaceWaterModel(AbstractModel):
    """Ponded surface-water store.  ``precipitation(t)`` returns a
    non-negative rain rate (m/s, scalar or per-column); ``tau_pond`` (s) is
    the pond-to-soil supply time scale; ``runoff`` optionally routes the
    pond laterally; ``h_evap_smoothing`` (m) blends evaporation from the
    bare-soil to the pond rate through the pond fraction
    ``w = clip(h_s / h_evap_smoothing, 0, 1)``."""

    precipitation: Callable[[Array], Array] = dataclasses.field(
        default_factory=ConstantPrecipitation
    )
    tau_pond: Array = 60.0
    runoff: Optional[Any] = None
    h_evap_smoothing: Array = 1e-4
    name: str = "surface"


@dataclasses.dataclass(frozen=True)
class LandModel(AbstractModel):
    """Soil column + surface-water store with conservative exchange.
    ``surface_update="step"`` evaluates the surface exchange once per time
    step, at the step's start state, and holds it across the stages
    (:class:`FrozenExchangeStepper`); ``"stage"`` evaluates it in every
    rhs call."""

    soil: SoilModel
    surface: SurfaceWaterModel = dataclasses.field(default_factory=SurfaceWaterModel)
    name: str = "land"
    surface_update: str = "stage"

    def __post_init__(self):
        if self.surface_update not in ("stage", "step"):
            raise ValueError(
                "LandModel.surface_update must be 'stage' or 'step'; got "
                f"{self.surface_update!r}"
            )
        if not isinstance(self.soil.hydrology_model, SoilHydrologyModel):
            raise TypeError(
                "LandModel surface coupling requires a dynamic soil hydrology model"
            )
        bc = self.soil.boundary_conditions
        if bc is not None and isinstance(bc.top, PrescribedAtmosForcing):
            if not isinstance(self.soil.energy_model, SoilEnergyModel):
                raise TypeError(
                    "LandModel with a PrescribedAtmosForcing top face needs "
                    "a dynamic SoilEnergyModel (MOST fluxes require the "
                    "soil surface temperature)"
                )

    @property
    def float_dtype(self):
        return self.soil.float_dtype

    @property
    def device(self):
        return self.soil.device

    @property
    def domain(self):
        return self.soil.domain

    def make_rhs(self, grid=None):
        """Composed tendency function."""
        return make_rhs(self, grid)


def potential_infiltration(soil: SoilModel, grid: ColumnGrid, X: dict, t) -> Array:
    """Potential downward infiltration rate at the top face: the magnitude
    of the soil's Dirichlet flux with the face at saturation (vartheta_l =
    nu)."""
    X_cf = initialize_boundary_values(X, "top")
    center = X_cf["vartheta_l"][0]
    face = torch.as_tensor(soil.soil_param_set.nu, dtype=center.dtype, device=center.device)
    X_cf = dict(X_cf, vartheta_l=[center, face.expand(center.shape)])
    flux_up = _dirichlet_hydrology_flux(soil.hydrology_model, soil, X_cf, grid.dz_boundary, "top")
    return sw._maximum(-flux_up, 0.0)


def _diagnose_state_T(soil: SoilModel, Y_soil: dict, Ya: dict) -> Array:
    """Temperature for the surface exchange: the prescribed profile when
    present, else diagnosed from rho_e_int, else 288 K."""
    name = soil.name
    vartheta_l = Y_soil["vartheta_l"]
    theta_i = Y_soil["theta_i"]
    if "T" in Ya.get(name, {}):
        return torch.as_tensor(Ya[name]["T"]).expand(vartheta_l.shape)
    if "rho_e_int" in Y_soil:
        sp = soil.soil_param_set
        theta_l = sw.volumetric_liquid_fraction(vartheta_l, sp.nu - theta_i)
        rho_c_s = sh.volumetric_heat_capacity(theta_l, theta_i, sp.rho_c_ds, soil.earth_param_set)
        return sh.temperature_from_rho_e_int(Y_soil["rho_e_int"], theta_i, rho_c_s, soil.earth_param_set)
    return torch.full_like(vartheta_l, 288.0)


def surface_exchange(land: LandModel, grid: ColumnGrid, X: dict, h_s, t) -> dict:
    """The exchange rates at the land surface for the surface state ``X =
    {vartheta_l, theta_i, T}``: ``P``; ``infiltration`` (downward
    positive); ``evap_soil`` / ``evap_pond`` (upward volume fluxes from the
    bare-soil fraction and the pond, zero without MOST); ``heat_flux``
    (upward, ``None`` without MOST)."""
    soil = land.soil
    P = land.surface.precipitation(t)
    check_rain(P)
    P = sw._maximum(torch.as_tensor(P, dtype=soil.float_dtype, device=h_s.device), 0.0)

    f_pot = potential_infiltration(soil, grid, X, t)
    supply = P + sw._maximum(h_s, 0.0) / land.surface.tau_pond
    infiltration = torch.minimum(supply, f_pot)

    zero = torch.zeros_like(infiltration)
    out = {"P": P, "infiltration": infiltration, "evap_soil": zero, "evap_pond": zero,
           "heat_flux": None}
    if isinstance(soil.boundary_conditions.top, PrescribedAtmosForcing):
        from landhydrology_tpu_torch.models.soil.surface_fluxes import (
            compute_blended_surface_fluxes,
        )

        top = X["vartheta_l"].shape[0] - 1
        w = sw._clip(sw._maximum(h_s, 0.0) / land.surface.h_evap_smoothing, 0.0, 1.0)
        fluxes = compute_blended_surface_fluxes(
            soil.energy_model, soil.hydrology_model, soil,
            X["vartheta_l"][top], X["theta_i"][top], X["T"][top], w, t,
        )
        out.update(fluxes)
    return out


def _exchange_from_state(land: LandModel, grid: ColumnGrid, Y: dict, Ya: dict, t) -> dict:
    """:func:`surface_exchange` at the state ``(Y, t)``, from the top cell
    alone (T is diagnosed on that slab)."""
    soil = land.soil
    name = soil.name
    h_s = Y[land.surface.name]["h_s"]
    nz = Y[name]["vartheta_l"].shape[0]
    nd = Y[name]["vartheta_l"].dim()
    Y_top = {k: v[nz - 1:nz] for k, v in Y[name].items()}
    # slice only column-shaped aux leaves (the prognostic rank and nz levels)
    Ya_top = {name: {
        k: (v[v.shape[0] - 1:v.shape[0]]
            if torch.is_tensor(v) and v.dim() == nd and v.shape[0] == nz else v)
        for k, v in Ya.get(name, {}).items()
    }}
    X = {
        "vartheta_l": Y_top["vartheta_l"],
        "theta_i": Y_top["theta_i"],
        "T": _diagnose_state_T(soil, Y_top, Ya_top),
    }
    return surface_exchange(land, grid, X, h_s, t)


def _rhs_given_exchange(land: LandModel, grid: ColumnGrid, Y: dict, Ya: dict, t, ex: dict,
                        C: Optional[dict] = None) -> dict:
    """The land tendency for fixed exchange rates ``ex`` (and, optionally,
    fixed soil coefficients ``C``, the ``coefficient_update="step"``
    composition): the soil sees ``-infiltration + evap_soil`` as its top
    water flux and the MOST heat flux (or its own top energy BC); the pond
    gains ``P - infiltration - evap_pond`` plus the routing tendency."""
    soil = land.soil
    name = soil.name
    h_s = Y[land.surface.name]["h_s"]
    infiltration = ex["infiltration"]
    bc = soil.boundary_conditions
    if ex["heat_flux"] is not None:
        energy_bc = VerticalFlux(ex["heat_flux"])
    else:
        energy_bc = getattr(bc.top, "energy", VerticalFlux(0.0))
    soil_t = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=VerticalFlux(-infiltration + ex["evap_soil"]), energy=energy_bc),
        bottom=bc.bottom,
    ))
    if C is not None:
        from landhydrology_tpu_torch.models.soil.lagged import make_coefficient_fns

        _, rhs_c = make_coefficient_fns(soil_t, grid)
        dY_soil = rhs_c(C, {name: Y[name]}, Ya, t)
    else:
        dY_soil = make_soil_rhs(soil_t, grid)({name: Y[name]}, Ya, t)
    dh_s = ex["P"] - infiltration - ex["evap_pond"]
    if land.surface.runoff is not None:
        dh_s = dh_s + routing_tendency(land.surface.runoff, h_s)
    return {name: dY_soil[name], land.surface.name: {"h_s": dh_s}}


def make_rhs(land: LandModel, grid: Optional[ColumnGrid] = None):
    """The composed tendency over ``{"soil": {...}, "surface": {"h_s":
    ...}}``, with the exchange evaluated at each call's own ``(Y, t)``;
    ``surface_update="step"`` is realized by :class:`FrozenExchangeStepper`."""
    soil = land.soil
    if grid is None:
        grid = make_function_space(soil.domain, soil.float_dtype, soil.device)

    def rhs(Y: dict, Ya: dict, t) -> dict:
        ex = _exchange_from_state(land, grid, Y, Ya, t)
        return _rhs_given_exchange(land, grid, Y, Ya, t, ex)

    return rhs


@dataclasses.dataclass(frozen=True)
class FrozenExchangeStepper:
    """Stepper decorator for the land model's step-level policies: with
    ``surface_update="step"`` the surface exchange, and with the soil's
    ``coefficient_update="step"`` the coefficient sweep, are evaluated once
    at the step's start state and held across the inner stepper's stages.
    The ``rhs`` argument of :meth:`step` is ignored."""

    inner: Any
    land: Any
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
        land = self.land
        grid = self.grid
        if grid is None:
            grid = make_function_space(land.soil.domain, land.float_dtype, land.soil.device)
        ex = _exchange_from_state(land, grid, Y, Ya, t) if land.surface_update == "step" else None
        C = None
        if land.soil.coefficient_update == "step":
            from landhydrology_tpu_torch.models.soil.lagged import make_coefficient_fns

            compute_coeffs, _ = make_coefficient_fns(land.soil, grid)
            C = compute_coeffs({land.soil.name: Y[land.soil.name]}, Ya, t)

        def frozen_rhs(Y_, Ya_, t_):
            ex_ = ex if ex is not None else _exchange_from_state(land, grid, Y_, Ya_, t_)
            return _rhs_given_exchange(land, grid, Y_, Ya_, t_, ex_, C=C)

        return self.inner.step(frozen_rhs, Y, Ya, t, dt)


def wrap_stepper_for_land(stepper, land, grid=None):
    """Apply the land model's step-level policies (frozen surface exchange
    and/or lagged soil coefficients) to a stepper; idempotent, and a no-op
    when both are ``"stage"`` and for other models."""
    wanted = (
        getattr(land, "surface_update", "stage") == "step"
        or getattr(getattr(land, "soil", None), "coefficient_update", "stage") == "step"
    )
    if wanted and not isinstance(stepper, FrozenExchangeStepper):
        return FrozenExchangeStepper(inner=stepper, land=land, grid=grid)
    return stepper


def initialize_states(land: LandModel, f_soil, t0, h_s0=0.0):
    """(Y, Ya) for the composed model: soil ICs from ``f_soil`` and the
    initial pond height (scalar or per-column)."""
    from landhydrology_tpu_torch.models.soil.initial_conditions import (
        initialize_states as soil_init,
    )

    Y, Ya = soil_init(land.soil, f_soil, t0)
    soil = land.soil
    h_s = torch.as_tensor(h_s0, dtype=soil.float_dtype, device=soil.device)
    Y[land.surface.name] = {"h_s": h_s.expand(soil.domain.batch_shape).contiguous()}
    return Y, Ya
