"""Goldens built with the PyTorch port alone, with no JAX.

- ``build_model_and_state``: golden #1 (``golden_config.build_model_and_state``),
  the same ``np.random.default_rng(42)`` draws in the same order, the same
  model, the same initial state; its trajectory is ``golden_coupled_f64.npz``,
  and with ``coefficient_update="step"`` ``golden_lagged_f64.npz``.
- ``build_freeze_model_and_state``: the freeze-thaw golden
  (``golden_config.build_freeze_model_and_state``), ``golden_freeze_f64.npz``.
- ``build_land_model_and_state``: the LandModel golden
  (``golden_config.build_land_model_and_state``: MOST atmosphere, rain
  pulse, pond, kinematic-wave routing on a 4 x 4 grid),
  ``golden_land_f64.npz``.
- ``build_forced_model_state_and_rows``: the forced golden
  (``golden_config.build_forced_model_state_and_rows``: MOST top driven by
  a per-step table with a scalar and per-column fields),
  ``golden_forced_f64.npz``.

The builders put their tensors on ``device``, the card unless the caller
asks for ``"cpu"``."""

import numpy as np

N_STEPS = 64
NZ = 24
NCOL = 8
DT = 10.0


def build_model_and_state(dtype, device="cuda"):
    import torch

    from landhydrology_tpu_torch import (
        Column,
        Dirichlet,
        FreeDrainage,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        k_solid,
        ksat_frozen,
        ksat_unfrozen,
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    rng = np.random.default_rng(42)
    nu = tensor(rng.uniform(0.42, 0.5, NCOL))
    hm = vanGenuchten(
        n=tensor(rng.uniform(1.6, 2.8, NCOL)),
        alpha=tensor(rng.uniform(2.0, 3.5, NCOL)),
        Ksat=tensor(rng.uniform(5e-7, 5e-6, NCOL)),
        theta_r=tensor(rng.uniform(0.0, 0.04, NCOL)),
    )
    ks = k_solid(0.0, 0.6, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu,
        S_s=1e-3,
        nu_ss_quartz=0.6,
        rho_c_ds=1.1e6,
        kappa_solid=ks,
        kappa_sat_unfrozen=ksat_unfrozen(ks, 0.45, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, 0.45, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-1.2, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=Dirichlet(lambda t: 0.31),
                energy=Dirichlet(lambda t: 290.0 + 0.0 * t),
            ),
            bottom=SoilComponentBC(
                hydrology=FreeDrainage(), energy=VerticalFlux(0.0)
            ),
        ),
        soil_param_set=msp,
        dtype=dtype,
        device=device,
    )

    def ic(z, m):
        z_np = z.cpu().numpy().reshape(NZ, 1)
        prof = tensor(0.12 + 0.25 * np.exp(z_np / 0.4) + 0.02 * rng.random((NZ, NCOL)))
        theta = torch.minimum(prof, 0.9 * nu)
        theta_i = torch.zeros((NZ, NCOL), dtype=dtype, device=device)
        T = tensor(285.0 + 4.0 * z_np + np.zeros((NZ, NCOL)))
        rcs = volumetric_heat_capacity(theta, theta_i, 1.1e6, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, DT


FREEZE_STEPS = 64
FREEZE_DT = 5.0


def build_freeze_model_and_state(dtype, device="cuda", nz=16, ncol=4, freeze_thaw=None):
    """Freeze-thaw golden: a coupled column cooled from above through the
    freezing point with rate-based phase change (``FreezeThaw(tau=60)``).
    ``nz``, ``ncol`` and ``freeze_thaw`` widen it or swap the scheme; the
    defaults are the golden's."""
    import torch

    from landhydrology_tpu_torch import (
        Column,
        Dirichlet,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-7, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=VerticalFlux(0.0),
                energy=Dirichlet(lambda t: 263.15),  # -10 C surface
            ),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        freeze_thaw=FreezeThaw(tau=60.0) if freeze_thaw is None else freeze_thaw,
        dtype=dtype,
        device=device,
    )

    def ic(z, m):
        th = torch.full((nz, ncol), 0.3, dtype=dtype, device=device)
        ti = torch.zeros((nz, ncol), dtype=dtype, device=device)
        T = torch.full((nz, ncol), 274.0, dtype=dtype, device=device)  # just above freezing
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, FREEZE_DT


LAND_STEPS = 48
LAND_DT = 2.0
LAND_NZ, LAND_NX, LAND_NY = 12, 4, 4


def build_land_model_and_state(dtype, device="cuda"):
    """LandModel golden: coupled soil + MOST atmosphere + rain pulse + pond
    + kinematic-wave routing over a terrain hill."""
    import torch

    from landhydrology_tpu_torch import (
        Column,
        PrescribedAtmosForcing,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import (
        KinematicWaveRouting,
        LandModel,
        PulsePrecipitation,
        SurfaceWaterModel,
        initialize_states as land_init,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    x = np.arange(LAND_NX)[:, None] - (LAND_NX - 1) / 2.0
    y = np.arange(LAND_NY)[None, :] - (LAND_NY - 1) / 2.0
    terrain = 0.2 * np.exp(-(x**2 + y**2) / 4.0)
    soil = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=LAND_NZ, batch_shape=(LAND_NX, LAND_NY)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        dtype=dtype,
        device=device,
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0, t_stop=60.0),
            tau_pond=120.0,
            runoff=KinematicWaveRouting(
                elevation=torch.as_tensor(terrain, dtype=dtype, device=device),
                manning_n=0.05, dx=1.0,
            ),
        ),
    )

    def ic(z, m):
        shape = (LAND_NZ, LAND_NX, LAND_NY)
        th = torch.full(shape, 0.22, dtype=dtype, device=device)
        ti = torch.zeros(shape, dtype=dtype, device=device)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        T = torch.full(shape, 292.0, dtype=dtype, device=device)
        return {"vartheta_l": th, "theta_i": ti, "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps)}

    Y, Ya = land_init(land, ic, 0.0, h_s0=2e-3)
    return land, Y, Ya, LAND_DT


FORCED_STEPS = 40
FORCED_DT = 60.0
FORCED_NZ, FORCED_NCOL = 12, 16


def build_forced_model_state_and_rows(dtype, device="cuda"):
    """Forced golden: a MOST-topped coupled column batch driven by a
    deterministic (trig-generated, RNG-free) per-step forcing table with a
    scalar ``u_atm`` row and per-column ``theta_atm`` / ``q_atm`` rows;
    ``golden_forced_f64.npz``."""
    import torch

    from landhydrology_tpu_torch import (
        Column,
        PrescribedAtmosForcing,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
        initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=FORCED_NZ, batch_shape=(FORCED_NCOL,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        dtype=dtype,
        device=device,
    )

    t = np.arange(FORCED_STEPS) * FORCED_DT
    phase = 2.0 * np.pi * np.arange(FORCED_NCOL) / FORCED_NCOL
    day = 2.0 * np.pi * t[:, None] / 86400.0 + phase[None, :]
    rows = {
        "u_atm": tensor(2.0 + 1.5 * np.sin(2e-4 * t)),
        "theta_atm": tensor(295.0 + 8.0 * np.sin(day - 0.5)),
        "q_atm": tensor(0.004 + 0.002 * np.cos(day)),
    }

    def ic(z, m):
        shape = (FORCED_NZ, FORCED_NCOL)
        th = tensor(np.broadcast_to(0.15 + 0.1 * np.linspace(0.0, 1.0, FORCED_NCOL)[None, :], shape).copy())
        ti = torch.zeros(shape, dtype=dtype, device=device)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {
            "vartheta_l": th,
            "theta_i": ti,
            "rho_e_int": volumetric_internal_energy(
                ti, rcs, torch.full(shape, 290.0, dtype=dtype, device=device), ps
            ),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, rows, FORCED_DT
