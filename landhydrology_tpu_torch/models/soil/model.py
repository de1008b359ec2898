"""Soil component-model lattice and the top-level SoilModel.

PyTorch port of ``landhydrology_tpu/models/soil/model.py``: the 2 energy x
2 hydrology lattice of frozen dataclasses; ``make_rhs`` (rhs.py) selects
the tendency by ``isinstance``.  The model carries an explicit ``dtype``
(default float64) and ``device``; its parameter tensors live there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from landhydrology_tpu_torch.constants import EarthParameterSet, default_earth_param_set
from landhydrology_tpu_torch.domains import Column
from landhydrology_tpu_torch.models.base import AbstractModel
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
class SoilModel(AbstractModel):
    """The soil column model aggregate: a configuration object that
    ``make_rhs(model)`` turns into the tendency function and
    ``initialize_states(model, ic, t0)`` into state tensors.

    Lateral coupling, freeze-thaw and lagged coefficients are not ported
    yet: a non-default ``lateral_coupling``, ``freeze_thaw`` or
    ``coefficient_update`` raises ``NotImplementedError``.
    """

    domain: Column
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
    device: Any = "cpu"
    lateral_coupling: Optional[Any] = None
    freeze_thaw: Optional[Any] = None
    #: static promise that theta_i is identically zero: drops the frozen
    #: branches of the thermal closures and the effective-porosity correction
    assume_no_ice: bool = False
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
        if self.coefficient_update == "step":
            raise NotImplementedError(
                "coefficient_update='step' (lagged coefficients, kernel B2) "
                "is not ported yet: ROADMAP A8"
            )
        if self.freeze_thaw is not None:
            raise NotImplementedError(
                "freeze_thaw (kernel B3) is not ported yet: ROADMAP A9"
            )
        if self.lateral_coupling is not None:
            raise NotImplementedError(
                "lateral_coupling is not ported yet: ROADMAP A13"
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
