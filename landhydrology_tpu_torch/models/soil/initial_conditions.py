"""Initial conditions / state allocation.

PyTorch port of ``landhydrology_tpu/models/soil/initial_conditions.py``.
The prognostic state ``Y = {model.name: {...}}`` holds ``vartheta_l`` +
``theta_i`` (dynamic hydrology) and/or ``rho_e_int`` (dynamic energy), each
a contiguous ``(nz, *batch)`` tensor on ``model.device``.  The auxiliary
state ``Ya = {'zc': ..., model.name: {...}}`` holds coordinates plus
prescribed fields.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)

Array = Any


def prognostic_vars(model: SoilModel) -> tuple:
    """Names of the prognostic variables for the model's component combo."""
    out = ()
    if isinstance(model.hydrology_model, SoilHydrologyModel):
        out += ("vartheta_l", "theta_i")
    if isinstance(model.energy_model, SoilEnergyModel):
        out += ("rho_e_int",)
    return out


def aux_vars(model: SoilModel) -> Callable[[Array, Array], dict]:
    """Init function ``(t, z) -> {aux fields}`` for the model's prescribed
    components."""

    def init_aux_soil(t, z):
        aux: dict = {}
        if isinstance(model.energy_model, PrescribedTemperatureModel):
            aux["T"] = model.energy_model.T_profile(z, t)
        if isinstance(model.hydrology_model, PrescribedHydrologyModel):
            aux["vartheta_l"] = model.hydrology_model.vartheta_l_profile(z, t)
            aux["theta_i"] = model.hydrology_model.theta_i_profile(z, t)
        return aux

    return init_aux_soil


def _tensor(x, model: SoilModel):
    return torch.as_tensor(x, dtype=model.float_dtype, device=model.device)


def initialize_prognostic(model: SoilModel, f: Callable, zc: Array, shape) -> dict:
    """Evaluate the IC function ``f(z, model) -> dict`` on center coordinates
    and broadcast each field to a contiguous tensor of the full state
    shape."""
    ic = f(zc, model)
    wanted = prognostic_vars(model)
    missing = [k for k in wanted if k not in ic]
    if missing:
        raise KeyError(
            f"Initial-condition function must provide {wanted}, missing {missing}"
        )
    soil = {k: _tensor(ic[k], model).expand(shape).clone() for k in wanted}
    return {model.name: soil}


def initialize_auxiliary(model: SoilModel, t0: Array, zc: Array) -> dict:
    """Auxiliary state at t0."""
    aux = aux_vars(model)(t0, zc)
    return {
        "zc": _tensor(zc, model),
        model.name: {k: _tensor(v, model) for k, v in aux.items()},
    }


def initialize_states(model: SoilModel, f: Callable, t0) -> tuple:
    """Initial (Y, Ya) for the model given an IC function ``f(z, model)``."""
    grid = make_function_space(model.domain, model.float_dtype, model.device)
    zc = grid.zc
    Y0 = initialize_prognostic(model, f, zc, grid.shape)
    Ya0 = initialize_auxiliary(model, torch.as_tensor(t0, dtype=model.float_dtype), zc)
    return Y0, Ya0


def default_initial_conditions(model: SoilModel) -> tuple:
    """Default ICs — only for the fully dynamic combo: isothermal at T_0,
    no ice, vartheta_l = nu/2."""
    if not (
        isinstance(model.energy_model, SoilEnergyModel)
        and isinstance(model.hydrology_model, SoilHydrologyModel)
    ):
        raise ValueError("No default IC exist for this type of soil model.")

    def ic(z, m: SoilModel):
        param_set = m.earth_param_set
        T = torch.full_like(z, 273.16)
        theta_i = torch.zeros_like(z)
        theta_l = torch.full_like(z, 0.5) * m.soil_param_set.nu
        rho_c_s = sh.volumetric_heat_capacity(
            theta_l, theta_i, m.soil_param_set.rho_c_ds, param_set
        )
        rho_e_int = sh.volumetric_internal_energy(theta_i, rho_c_s, T, param_set)
        return {"vartheta_l": theta_l, "theta_i": theta_i, "rho_e_int": rho_e_int}

    return initialize_states(model, ic, 0.0)
