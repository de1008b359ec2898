"""Planet-level physical constants.

PyTorch port of ``landhydrology_tpu/constants.py``: the same frozen
dataclass with the same values.  It holds Python floats only, so it is
shared by the eager tensor code and the CUDA kernel's scalar arguments.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EarthParameterSet:
    """Physical constants of the planet (SI units)."""

    # Universal / composition primitives
    gas_constant: float = 8.3144598  # J/mol/K
    molmass_dryair: float = 28.97e-3  # kg/mol
    molmass_water: float = 18.01528e-3  # kg/mol
    kappa_d: float = 2.0 / 7.0  # R_d / cp_d for dry air

    # Heat capacities (isobaric, specific; J/kg/K)
    cp_v: float = 1859.0
    cp_l: float = 4181.0
    cp_i: float = 2100.0

    # Reference temperatures / triple point
    T_0: float = 273.16  # thermodynamic reference temperature, K
    T_triple: float = 273.16  # triple-point temperature, K
    press_triple: float = 611.657  # triple-point vapor pressure, Pa

    # Latent heats at T_0 (J/kg)
    LH_v0: float = 2.5008e6  # vaporization
    LH_s0: float = 2.8344e6  # sublimation

    # Densities (kg/m^3)
    rho_cloud_liq: float = 1.0e3
    rho_cloud_ice: float = 916.7

    # Gravity (m/s^2)
    grav: float = 9.81

    # Thermal conductivity of dry air (W/m/K); CLIMAParameters K_therm
    K_therm: float = 2.4e-2

    # von Karman constant (Monin-Obukhov theory)
    von_karman_const: float = 0.4

    # ---- derived accessors (computed, not stored) ----

    @property
    def R_d(self) -> float:
        """Dry-air gas constant, J/kg/K."""
        return self.gas_constant / self.molmass_dryair

    @property
    def R_v(self) -> float:
        """Water-vapor gas constant, J/kg/K."""
        return self.gas_constant / self.molmass_water

    @property
    def cp_d(self) -> float:
        """Dry-air isobaric specific heat, J/kg/K."""
        return self.R_d / self.kappa_d

    @property
    def LH_f0(self) -> float:
        """Latent heat of fusion at T_0, J/kg (LH_s0 - LH_v0)."""
        return self.LH_s0 - self.LH_v0

    @property
    def molmass_ratio(self) -> float:
        """Molar-mass ratio dry air / water."""
        return self.molmass_dryair / self.molmass_water

    @property
    def rho_cp_l(self) -> float:
        """Volumetric isobaric heat capacity of liquid water, J/m^3/K."""
        return self.cp_l * self.rho_cloud_liq

    @property
    def rho_cp_i(self) -> float:
        """Volumetric isobaric heat capacity of ice, J/m^3/K."""
        return self.cp_i * self.rho_cloud_ice


#: A module-level default instance (immutable).
default_earth_param_set = EarthParameterSet()
