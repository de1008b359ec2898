"""Boundary conditions and the uniform state->flux conversion layer.

PyTorch port of ``landhydrology_tpu/models/soil/boundary.py``.  Every BC
type is converted into a flux value that the divergence sets on the
boundary face.  BC values may be scalars, ``(ncol,)`` tensors, or callables
of time.

Sign convention: flux positive along +z.  For Dirichlet-derived gradient
fluxes the state difference changes orientation at the bottom face while
the gravitational contribution does not (the JAX package's deliberate
deviation from the Julia reference); FreeDrainage is bottom-only and never
negated.  The center-to-face distance at a boundary is the half cell dz/2.

``PrescribedAtmosForcing`` at the top face converts the surface state into
Monin-Obukhov turbulent fluxes (``surface_fluxes.py``).  ``BatchedBC``
gives every column its own BC type (``BCKind``): the conversion evaluates
each formula and selects per column.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from landhydrology_tpu_torch.domains import ColumnGrid
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil import water as sw
from landhydrology_tpu_torch.models.soil.model import (
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any
ValueLike = Union[float, Array, Callable[[Array], Array]]


# --------------------------------------------------------------------------
# BC types
# --------------------------------------------------------------------------


class AbstractBC:
    """Per-component boundary condition."""


@dataclasses.dataclass(frozen=True)
class NoBC(AbstractBC):
    """No boundary condition — prescribed components."""


@dataclasses.dataclass(frozen=True)
class VerticalFlux(AbstractBC):
    """Prescribed vertical boundary flux, positive along +z; a constant, a
    per-column tensor or a callable of time."""

    flux: ValueLike = 0.0


@dataclasses.dataclass(frozen=True)
class Dirichlet(AbstractBC):
    """Boundary value of the state (vartheta_l for hydrology, T for
    energy), possibly time dependent."""

    state_value: ValueLike = 0.0


@dataclasses.dataclass(frozen=True)
class FreeDrainage(AbstractBC):
    """Free drainage at the bottom: grad(h) = 1, flux = -K(theta_center)."""


class BCKind:
    """Integer codes of the per-column BC types of :class:`BatchedBC`."""

    FLUX = 0
    DIRICHLET = 1
    FREE_DRAINAGE = 2


@dataclasses.dataclass(frozen=True)
class BatchedBC(AbstractBC):
    """Per-column mixed BC types: ``kind`` is an integer tensor of
    :class:`BCKind` codes broadcastable to the column batch; ``value`` is the
    prescribed flux of a FLUX column and the boundary state of a DIRICHLET
    column (ignored for FREE_DRAINAGE), a constant, a per-column tensor or a
    callable of time."""

    kind: Array
    value: ValueLike = 0.0


class AbstractFaceBC:
    """All BCs attached to one boundary face."""


@dataclasses.dataclass(frozen=True)
class SoilComponentBC(AbstractFaceBC):
    """Energy + hydrology BCs for one face."""

    energy: AbstractBC = dataclasses.field(default_factory=NoBC)
    hydrology: AbstractBC = dataclasses.field(default_factory=NoBC)

    def __post_init__(self):
        if isinstance(self.energy, BatchedBC) and bool(
            torch.any(torch.as_tensor(self.energy.kind) == BCKind.FREE_DRAINAGE)
        ):
            raise ValueError(
                "BatchedBC kind FREE_DRAINAGE is not defined for the energy "
                "component (it is a hydrology-only BC)"
            )


@dataclasses.dataclass(frozen=True)
class PrescribedAtmosForcing(AbstractFaceBC):
    """Atmospheric state driving Monin-Obukhov surface fluxes at the top
    face.  Each field is a scalar, a per-column ``(ncol,)`` tensor or a
    callable of time."""

    u_atm: ValueLike  # wind speed at z_atm (m/s)
    theta_atm: ValueLike  # potential temperature at z_atm (K)
    z_atm: ValueLike  # measurement height (m)
    theta_scale: ValueLike  # potential temperature scale (K)
    rho_a_sfc: ValueLike  # moist air density at the surface (kg/m^3)
    q_atm: ValueLike  # specific humidity at z_atm


@dataclasses.dataclass(frozen=True)
class SoilColumnBC:
    """BCs for both boundary faces."""

    top: AbstractFaceBC = dataclasses.field(default_factory=SoilComponentBC)
    bottom: SoilComponentBC = dataclasses.field(default_factory=SoilComponentBC)

    def __post_init__(self):
        if isinstance(self.bottom, PrescribedAtmosForcing):
            raise ValueError(
                "Prescribed atmosphere-driven boundary conditions are only "
                "valid at the top of the soil column."
            )


# --------------------------------------------------------------------------
# State -> flux conversion
# --------------------------------------------------------------------------


def _value_at(v: ValueLike, t: Array, like: Array) -> Array:
    """A BC value at time ``t`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(
        v(t) if callable(v) else v, dtype=like.dtype, device=like.device
    )


def interior_values(X: dict, face: str) -> tuple:
    """Nearest-center (vartheta_l, theta_i, T) to the boundary ``face``:
    ``(*batch)`` slices of the ``(nz, *batch)`` fields."""
    if face not in ("top", "bottom"):
        raise ValueError("Expected 'top' or 'bottom'")
    idx = X["vartheta_l"].shape[0] - 1 if face == "top" else 0
    return X["vartheta_l"][idx], X["theta_i"][idx], X["T"][idx]


def boundary_cf_distance(face: str, grid: ColumnGrid) -> float:
    """Distance from the last center to the boundary face: the half cell."""
    return grid.dz_boundary


def initialize_boundary_values(X: dict, face: str) -> dict:
    """(center, face) value pairs for vartheta_l, theta_i, T, with the face
    initialized to the center value."""
    vartheta_l, theta_i, T = interior_values(X, face)
    return {
        "vartheta_l": [vartheta_l, vartheta_l],
        "theta_i": [theta_i, theta_i],
        "T": [T, T],
    }


def set_boundary_values(X_cf: dict, bc: AbstractBC, component, t: Array) -> dict:
    """Overwrite the face entry of the pair for Dirichlet BCs; no-op
    otherwise (a ``BatchedBC`` DIRICHLET column sets its face only inside
    its own flux)."""
    if isinstance(bc, Dirichlet) and isinstance(
        component, (SoilEnergyModel, SoilHydrologyModel)
    ):
        key = "T" if isinstance(component, SoilEnergyModel) else "vartheta_l"
        return _with_face_value(X_cf, component, _value_at(bc.state_value, t, X_cf[key][0]))
    return X_cf


def _with_face_value(X_cf: dict, component, value: Array) -> dict:
    """A copy of the (center, face) pairs with the component's Dirichlet
    state at the face."""
    key = "T" if isinstance(component, SoilEnergyModel) else "vartheta_l"
    center = X_cf[key][0]
    return dict(X_cf, **{key: [center, value.expand(center.shape)]})


def _pairwise(fn, pair_args):
    """Evaluate ``fn`` at the center (index 0) and face (index 1) entries of
    (center, face) pairs; scalar args are shared."""
    out = []
    for i in (0, 1):
        out.append(fn(*[a[i] if isinstance(a, list) else a for a in pair_args]))
    return out


def _free_drainage_flux(component, model: SoilModel, X_cf: dict) -> Array:
    """flux = -K(theta_center): grad(h) = 1 at the bottom."""
    sp = model.soil_param_set
    vartheta_l = X_cf["vartheta_l"][0]
    theta_i = X_cf["theta_i"][0]
    T = X_cf["T"][0]
    hm = component.hydraulic_model
    nu_eff = sp.nu - theta_i
    theta_l = sw.volumetric_liquid_fraction(vartheta_l, nu_eff)
    f_i = sw.ice_fraction_of_water(theta_l, theta_i)
    impedance_f = sw.impedance_factor(component.impedance_factor, f_i)
    viscosity_f = sw.viscosity_factor(component.viscosity_factor, T)
    S = sw.effective_saturation(sp.nu, vartheta_l, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, viscosity_f, impedance_f)
    return -K


def _dirichlet_hydrology_flux(
    component, model: SoilModel, X_cf: dict, dz: Array, face: str
) -> Array:
    """Dirichlet water flux from the one-sided head gradient at the face.

    Top face: flux = -K_face (psi_f - psi_c + dz)/dz.  Bottom face:
    flux = -K_face (psi_c - psi_f + dz)/dz — only the psi difference
    changes orientation; the gravitational +dz term does not (the JAX
    package's fix of the Julia reference's blanket negation)."""
    sp = model.soil_param_set
    hm = component.hydraulic_model
    theta_i_pair = X_cf["theta_i"]
    nu_eff = [sp.nu - th for th in theta_i_pair]
    theta_l = _pairwise(sw.volumetric_liquid_fraction, [X_cf["vartheta_l"], nu_eff])
    f_i = _pairwise(sw.ice_fraction_of_water, [theta_l, theta_i_pair])
    impedance_f = [sw.impedance_factor(component.impedance_factor, f) for f in f_i]
    viscosity_f = [
        sw.viscosity_factor(component.viscosity_factor, T) for T in X_cf["T"]
    ]
    S = _pairwise(
        lambda v: sw.effective_saturation(sp.nu, v, hm.theta_r),
        [X_cf["vartheta_l"]],
    )
    K = [
        sw.hydraulic_conductivity(hm, S[i], viscosity_f[i], impedance_f[i])
        for i in (0, 1)
    ]
    psi = _pairwise(
        lambda v, ne: sw.pressure_head(hm, v, ne, sp.S_s),
        [X_cf["vartheta_l"], nu_eff],
    )
    if face == "bottom":
        return -K[1] * (psi[0] - psi[1] + dz) / dz
    return -K[1] * (psi[1] - psi[0] + dz) / dz


def _dirichlet_energy_flux(
    model: SoilModel, X_cf: dict, dz: Array, face: str
) -> Array:
    """flux = -kappa_face (T_face - T_center) / dz, negated at the bottom."""
    sp = model.soil_param_set
    kappa_dry = sh.k_dry(model.earth_param_set, sp)
    theta_i_pair = X_cf["theta_i"]
    nu_eff = [sp.nu - th for th in theta_i_pair]
    theta_l = _pairwise(sw.volumetric_liquid_fraction, [X_cf["vartheta_l"], nu_eff])
    S_r = _pairwise(
        lambda tl, ti: sh.relative_saturation(tl, ti, sp.nu),
        [theta_l, theta_i_pair],
    )
    kersten = _pairwise(
        lambda ti, sr: sh.kersten_number(ti, sr, sp), [theta_i_pair, S_r]
    )
    kappa_sat = _pairwise(
        lambda tl, ti: sh.saturated_thermal_conductivity(
            tl, ti, sp.kappa_sat_unfrozen, sp.kappa_sat_frozen
        ),
        [theta_l, theta_i_pair],
    )
    kappa = _pairwise(sh.thermal_conductivity, [kappa_dry, kersten, kappa_sat])
    T = X_cf["T"]
    flux = -kappa[1] * (T[1] - T[0]) / dz
    return -flux if face == "bottom" else flux


def vertical_flux(
    bc: AbstractBC,
    component,
    X_cf: Optional[dict],
    model: SoilModel,
    dz: Array,
    face: str,
    t: Array,
) -> Optional[Array]:
    """Boundary flux for one (bc, component) combination; ``None`` for
    NoBC."""
    if isinstance(bc, NoBC):
        return None

    if isinstance(bc, VerticalFlux):
        return _value_at(bc.flux, t, X_cf["vartheta_l"][0])

    if isinstance(bc, FreeDrainage):
        if not isinstance(component, SoilHydrologyModel):
            raise TypeError("FreeDrainage applies to the hydrology component only.")
        return _free_drainage_flux(component, model, X_cf)

    if isinstance(bc, Dirichlet):
        if isinstance(component, SoilHydrologyModel):
            return _dirichlet_hydrology_flux(component, model, X_cf, dz, face)
        if isinstance(component, SoilEnergyModel):
            return _dirichlet_energy_flux(model, X_cf, dz, face)

    if isinstance(bc, BatchedBC):
        # every formula the kinds can name, selected per column with nested
        # torch.where: a product with a mask would carry the NaN of a flux
        # column's Dirichlet candidate
        like = X_cf["vartheta_l"][0]
        value = _value_at(bc.value, t, like)
        kind = torch.as_tensor(bc.kind, device=like.device)
        X_dir = _with_face_value(X_cf, component, value)
        candidates = [value]  # FLUX: the prescribed value itself
        if isinstance(component, SoilHydrologyModel):
            candidates.append(_dirichlet_hydrology_flux(component, model, X_dir, dz, face))
            candidates.append(_free_drainage_flux(component, model, X_cf))
        elif isinstance(component, SoilEnergyModel):
            candidates.append(_dirichlet_energy_flux(model, X_dir, dz, face))
            candidates.append(torch.zeros_like(candidates[0]))  # no energy free drainage
        else:
            raise TypeError("BatchedBC requires a dynamic component model.")
        shape = torch.broadcast_shapes(*(c.shape for c in candidates), kind.shape)
        c = [x.expand(shape) for x in candidates]
        kind = kind.expand(shape)
        return torch.where(
            kind == BCKind.FLUX, c[0], torch.where(kind == BCKind.DIRICHLET, c[1], c[2])
        )

    raise TypeError(f"Unsupported BC {bc!r} for component {component!r}")


def boundary_fluxes(
    X: dict,
    bc: AbstractFaceBC,
    face: str,
    model: SoilModel,
    grid: ColumnGrid,
    t: Array,
) -> dict:
    """Boundary fluxes ``{'f_rho_e_int':…, 'f_vartheta_l':…}`` for all soil
    components at one face; ``None`` for NoBC components.

    ``X`` is the extended state ``{'vartheta_l', 'theta_i', 'T'}`` on
    centers.  The face values of BOTH components are overwritten before
    either flux is computed, so a Dirichlet T enters the hydrology face K
    (viscosity) and a Dirichlet vartheta_l enters the energy face kappa.
    A ``PrescribedAtmosForcing`` top gives the MOST turbulent fluxes of the
    top cell's state.
    """
    if isinstance(bc, PrescribedAtmosForcing):
        if face != "top":
            raise ValueError(
                "Prescribed atmosphere-driven boundary conditions are only "
                "valid at the top of the soil column."
            )
        from landhydrology_tpu_torch.models.soil.surface_fluxes import (
            compute_turbulent_surface_fluxes,
        )

        vartheta_l, theta_i, T = interior_values(X, face)
        f_rho_e_int, f_vartheta_l = compute_turbulent_surface_fluxes(
            model.energy_model, model.hydrology_model, model, vartheta_l, theta_i, T, t
        )
        return {"f_rho_e_int": f_rho_e_int, "f_vartheta_l": f_vartheta_l}
    if not isinstance(bc, SoilComponentBC):
        raise TypeError(f"Unsupported face BC {bc!r}")
    energy = model.energy_model
    hydrology = model.hydrology_model
    X_cf = initialize_boundary_values(X, face)
    X_cf = set_boundary_values(X_cf, bc.energy, energy, t)
    X_cf = set_boundary_values(X_cf, bc.hydrology, hydrology, t)

    dz = boundary_cf_distance(face, grid)
    f_rho_e_int = vertical_flux(bc.energy, energy, X_cf, model, dz, face, t)
    f_vartheta_l = vertical_flux(bc.hydrology, hydrology, X_cf, model, dz, face, t)
    return {"f_rho_e_int": f_rho_e_int, "f_vartheta_l": f_vartheta_l}
