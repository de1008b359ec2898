"""Soil parameter set (port of ``landhydrology_tpu/models/soil/params.py``).

Every field is a Python scalar or a ``(ncol,)`` tensor that broadcasts
against the trailing column axis of the state (heterogeneous soils).
"""

from __future__ import annotations

import dataclasses
from typing import Any

Array = Any


@dataclasses.dataclass(frozen=True)
class SoilParams:
    """Soil/texture/surface parameters; defaults correspond to loam."""

    #: porosity
    nu: Array = 0.43
    #: specific storage (1/m)
    S_s: Array = 1e-3
    #: volumetric fraction of soil solids in gravel
    nu_ss_gravel: Array = 0.0
    #: volumetric fraction of soil solids in organic matter
    nu_ss_om: Array = 0.0
    #: volumetric fraction of soil solids in quartz/sand
    nu_ss_quartz: Array = 0.41
    #: volumetric heat capacity of dry soil (J/m^3/K)
    rho_c_ds: Array = 2700.0
    #: thermal conductivity of soil solids (W/m/K)
    kappa_solid: Array = 3.97
    #: particle density (kg/m^3)
    rho_p: Array = 2700.0
    #: thermal conductivity of saturated unfrozen soil (W/m/K)
    kappa_sat_unfrozen: Array = 1.72
    #: thermal conductivity of saturated frozen soil (W/m/K)
    kappa_sat_frozen: Array = 3.13
    #: Balland & Arp Kersten-number parameter a
    a: Array = 0.24
    #: Balland & Arp Kersten-number parameter b
    b: Array = 18.1
    #: Balland & Arp kappa_dry parameter
    kappa_dry_parameter: Array = 0.053
    #: surface roughness length for momentum (m)
    z_0m: Array = 0.001
    #: surface roughness length for scalars (m)
    z_0s: Array = 0.001
