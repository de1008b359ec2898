"""Soil component-model lattice and the top-level SoilModel.

PyTorch port of ``landhydrology_tpu/models/soil/model.py``: the 2 energy x
2 hydrology lattice of frozen dataclasses; ``make_rhs`` (rhs.py) selects
the tendency by ``isinstance``.  The model carries an explicit ``dtype``
(default float64) and ``device`` (default ``"cuda"``; CPU runs ask for
``device="cpu"``); its parameter tensors live there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from landhydrology_tpu_torch.constants import EarthParameterSet, default_earth_param_set
from landhydrology_tpu_torch.models.base import AbstractModel
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    EquilibriumFreezeThaw,
    FreezeThaw,
)
from landhydrology_tpu_torch.models.soil.params import SoilParams
from landhydrology_tpu_torch.models.soil.water import (
    AbstractConductivityFactor,
    NoEffect,
    vanGenuchten,
)

Array = Any


class AbstractSoilComponentModel:
    """Supertype of the soil component models."""


@dataclasses.dataclass(frozen=True)
class SoilEnergyModel(AbstractSoilComponentModel):
    """Solve the soil heat PDE for rho_e_int."""


@dataclasses.dataclass(frozen=True)
class SoilHydrologyModel(AbstractSoilComponentModel):
    """Solve Richards equation for vartheta_l."""

    hydraulic_model: vanGenuchten = dataclasses.field(default_factory=vanGenuchten)
    viscosity_factor: AbstractConductivityFactor = dataclasses.field(
        default_factory=NoEffect
    )
    impedance_factor: AbstractConductivityFactor = dataclasses.field(
        default_factory=NoEffect
    )


def _default_T_profile(z, t):
    """288 K everywhere — the viscosity-effect reference temperature."""
    return torch.full_like(z, 288.0)


def _default_zero_profile(z, t):
    return torch.zeros_like(z)


@dataclasses.dataclass(frozen=True)
class PrescribedTemperatureModel(AbstractSoilComponentModel):
    """Prescribe T(z, t) instead of solving the heat PDE."""

    T_profile: Callable[[Array, Array], Array] = _default_T_profile


@dataclasses.dataclass(frozen=True)
class PrescribedHydrologyModel(AbstractSoilComponentModel):
    """Prescribe vartheta_l(z, t) and theta_i(z, t) instead of solving
    Richards equation."""

    vartheta_l_profile: Callable[[Array, Array], Array] = _default_zero_profile
    theta_i_profile: Callable[[Array, Array], Array] = _default_zero_profile


@dataclasses.dataclass(frozen=True)
class LateralSurfaceCoupling:
    """Lateral surface-water coupling between neighbouring columns on a 2-D
    ``(nx, ny)`` column batch: the top cell of each column exchanges water
    with its four neighbours by linear diffusion of the surface hydraulic
    head,

        d vartheta_l[top] / dt  +=  (c / dz) * lap_xy(h[top]),

    with ``lap_xy`` the 5-point Laplacian on the periodic column grid and
    ``c`` a surface conductance (m^2/s).  Eager engine only: the column
    kernels do not couple columns."""

    conductance: Array = 1e-6  # m^2/s
    dx: Array = 1.0  # lateral grid spacing (m)


@dataclasses.dataclass(frozen=True)
class SoilModel(AbstractModel):
    """The soil column model aggregate: a configuration object that
    ``make_rhs(model)`` turns into the tendency function and
    ``initialize_states(model, ic, t0)`` into state tensors.

    ``freeze_thaw`` is ``None``, a :class:`FreezeThaw` (rate sources in the
    rhs) or an :class:`EquilibriumFreezeThaw` (a projection after each
    step); ``coefficient_update="step"`` evaluates the nonlinear
    coefficients once per step (``lagged.py``).  ``domain`` is a ``Column``
    or a ``VariableDepthColumn``; ``lateral_coupling`` a
    :class:`LateralSurfaceCoupling` on a 2-D column batch.
    """

    domain: Any
    energy_model: AbstractSoilComponentModel = dataclasses.field(
        default_factory=SoilEnergyModel
    )
    hydrology_model: AbstractSoilComponentModel = dataclasses.field(
        default_factory=SoilHydrologyModel
    )
    boundary_conditions: Any = None  # SoilColumnBC; typed in boundary.py
    soil_param_set: SoilParams = dataclasses.field(default_factory=SoilParams)
    earth_param_set: EarthParameterSet = default_earth_param_set
    name: str = "soil"
    dtype: torch.dtype = torch.float64
    device: Any = "cuda"
    #: optional cross-column surface coupling (a 2-D column batch)
    lateral_coupling: Optional[LateralSurfaceCoupling] = None
    #: optional phase change, coupled combination only
    freeze_thaw: Optional[Any] = None
    #: static promise that theta_i is identically zero: drops the frozen
    #: branches of the thermal closures and the effective-porosity correction
    assume_no_ice: bool = False
    #: ``"stage"``: coefficients in every RK stage; ``"step"``: once per
    #: step, frozen across the stages (LaggedCoefficientStepper)
    coefficient_update: str = "stage"

    def __post_init__(self):
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64; got {self.dtype}")
        if self.assume_no_ice and self.freeze_thaw is not None:
            raise ValueError("assume_no_ice is incompatible with freeze_thaw")
        if self.coefficient_update not in ("stage", "step"):
            raise ValueError(
                "SoilModel.coefficient_update must be 'stage' or 'step'; "
                f"got {self.coefficient_update!r}"
            )
        if self.freeze_thaw is not None:
            if not isinstance(self.freeze_thaw, (FreezeThaw, EquilibriumFreezeThaw)):
                raise TypeError(
                    "freeze_thaw must be a FreezeThaw or an EquilibriumFreezeThaw; "
                    f"got {type(self.freeze_thaw).__name__}"
                )
            # the phase change reads rho_e_int and the retention curve
            if not isinstance(self.energy_model, SoilEnergyModel):
                raise TypeError(
                    "freeze_thaw requires a dynamic SoilEnergyModel (phase "
                    "change is driven by the prognostic rho_e_int); got "
                    f"{type(self.energy_model).__name__}"
                )
            if not isinstance(self.hydrology_model, SoilHydrologyModel):
                raise TypeError(
                    "freeze_thaw requires a dynamic SoilHydrologyModel (the "
                    "equilibrium liquid fraction comes from its retention "
                    f"curve); got {type(self.hydrology_model).__name__}"
                )

    @property
    def float_dtype(self) -> torch.dtype:
        return self.dtype

    def default_initial_conditions(self):
        """Default ICs: isothermal at T_0, no ice, vartheta_l = nu/2; only
        for the fully dynamic combination."""
        from landhydrology_tpu_torch.models.soil.initial_conditions import (
            default_initial_conditions,
        )

        return default_initial_conditions(self)

    def make_rhs(self, grid=None):
        """Tendency function for this model."""
        from landhydrology_tpu_torch.models.soil.rhs import make_rhs

        return make_rhs(self, grid)
