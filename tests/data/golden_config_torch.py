"""Golden #1 (``golden_config.build_model_and_state``) built with the
PyTorch port alone, with no JAX: the same ``np.random.default_rng(42)``
draws in the same order, the same model, the same initial state.  The
reference trajectory is ``golden_coupled_f64.npz``."""

import numpy as np

N_STEPS = 64
NZ = 24
NCOL = 8
DT = 10.0


def build_model_and_state(dtype, device="cpu"):
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
