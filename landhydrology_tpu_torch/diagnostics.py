"""Conservation monitors and the explicit time-step estimate.

PyTorch port of the ``water_mass``, ``energy_total`` and
``explicit_dt_limit`` parts of ``landhydrology_tpu/diagnostics.py``.
"""

from __future__ import annotations

from typing import Any

import torch

Array = Any


def water_mass(Y: dict, dz, name: str = "soil", param_set=None) -> Array:
    """Column-integrated water (liquid + ice as liquid-equivalent), summed
    over all columns: sum(vartheta_l + (rho_i/rho_l) theta_i) dz."""
    from landhydrology_tpu_torch.constants import default_earth_param_set

    if param_set is None:
        param_set = default_earth_param_set
    soil = Y[name]
    total = soil["vartheta_l"]
    if "theta_i" in soil:
        total = total + (
            param_set.rho_cloud_ice / param_set.rho_cloud_liq
        ) * soil["theta_i"]
    return torch.sum(total) * dz


def energy_total(Y: dict, dz, name: str = "soil") -> Array:
    """Column-integrated volumetric internal energy."""
    return torch.sum(Y[name]["rho_e_int"]) * dz


def explicit_dt_limit(model, Y: dict, safety: float = 1.0) -> Array:
    """Estimate the explicit SSPRK-stable time step for the Richards
    diffusion from the face-coupled stiffness

        lambda_i ~ (K_{i-1/2} + K_{i+1/2}) C_i / dz^2,
        dt <= safety * 2.5 / max_i lambda_i

    with C = |d psi / d vartheta_l| from ``torch.autograd.grad`` of the
    pressure head (2.5 ~ SSPRK33's real-axis stability extent); on a
    ``VariableDepthColumn`` each column's own dz."""
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.models.soil import water as sw
    from landhydrology_tpu_torch.ops.stencil import interp_c2f_interior

    sp = model.soil_param_set
    hm = model.hydrology_model.hydraulic_model
    grid = make_function_space(model.domain, model.float_dtype, model.device)
    v = Y[model.name]["vartheta_l"].detach()
    theta_i = Y[model.name].get("theta_i", torch.zeros_like(v))
    nu_eff = sp.nu - theta_i
    S = sw.effective_saturation(sp.nu, v, hm.theta_r)
    K = sw.hydraulic_conductivity(hm, S, 1.0, 1.0)

    with torch.enable_grad():
        vv = v.clone().requires_grad_(True)
        total = torch.sum(sw.pressure_head(hm, vv, nu_eff, sp.S_s))
        (dpsi,) = torch.autograd.grad(total, vv)
    C = torch.abs(dpsi)
    Kf = interp_c2f_interior(K)
    zeros = torch.zeros_like(K[:1])
    K_minus = torch.cat([zeros, Kf], dim=0)
    K_plus = torch.cat([Kf, zeros], dim=0)
    lam = (K_minus + K_plus) * C / (grid.dz * grid.dz)
    return safety * 2.5 / torch.clamp(torch.max(lam), min=1e-30)
