"""The soil column model family: water/heat parameterizations, parameters,
model types, boundary conditions, RHS assembly and initial conditions."""

from landhydrology_tpu_torch.models.soil import heat as SoilHeatParameterizations
from landhydrology_tpu_torch.models.soil import water as SoilWaterParameterizations
from landhydrology_tpu_torch.models.soil.boundary import (
    BatchedBC,
    BCKind,
    Dirichlet,
    FreeDrainage,
    NoBC,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
    boundary_fluxes,
)
from landhydrology_tpu_torch.models.soil.initial_conditions import (
    default_initial_conditions,
    initialize_auxiliary,
    initialize_prognostic,
    initialize_states,
    prognostic_vars,
)
from landhydrology_tpu_torch.models.soil.model import (
    LateralSurfaceCoupling,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.params import SoilParams
from landhydrology_tpu_torch.models.soil.rhs import make_rhs, make_update_aux
from landhydrology_tpu_torch.models.soil.surface_fluxes import (
    compute_turbulent_surface_fluxes,
)
from landhydrology_tpu_torch.models.soil.water import (
    IceImpedance,
    NoEffect,
    TemperatureDependentViscosity,
    vanGenuchten,
)

__all__ = [
    "SoilWaterParameterizations",
    "SoilHeatParameterizations",
    "SoilParams",
    "SoilModel",
    "SoilEnergyModel",
    "SoilHydrologyModel",
    "PrescribedTemperatureModel",
    "PrescribedHydrologyModel",
    "vanGenuchten",
    "NoEffect",
    "TemperatureDependentViscosity",
    "IceImpedance",
    "NoBC",
    "BatchedBC",
    "BCKind",
    "LateralSurfaceCoupling",
    "VerticalFlux",
    "Dirichlet",
    "FreeDrainage",
    "SoilComponentBC",
    "SoilColumnBC",
    "PrescribedAtmosForcing",
    "boundary_fluxes",
    "compute_turbulent_surface_fluxes",
    "make_rhs",
    "make_update_aux",
    "initialize_states",
    "initialize_prognostic",
    "initialize_auxiliary",
    "default_initial_conditions",
    "prognostic_vars",
]
