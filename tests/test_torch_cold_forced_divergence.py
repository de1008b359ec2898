"""The columns of ``chip_smoke.py`` phase 17b's cold forced reanalysis that
leave the physical range leave it in the JAX package too, at the same step.

``experiments/soil/forced_reanalysis.py``'s LandModel under
``FreezeThaw(tau=3600)``, started at 273.4-275.4 K by column with its
forcing's air temperature 24 K lower (``chip_smoke.build_cold_reanalysis``,
``reanalysis_forcing``), stays finite while the air freezes its top cells.
Once the rain band reaches a frozen top cell, that cell's potential
infiltration sees the face saturated at nu over the ice (psi = theta_i /
S_s), the cell saturates, and at dt = 120 s the SSPRK33 step passes its
explicit limit and blows up, from about step 74.  Phase 17b therefore runs
``chip_smoke.COLD_FORCED_STEPS`` steps.

Here a few columns of the full-width run (131,072 columns, nz=24, f64): rain
band columns that blow up, and a column the band has not reached, go one
forcing row at a time through the JAX package's forced segment (its XLA
engine, the reference semantics) and through the port's fused run's plain
version (what phase 17b holds the kernel to), ``STEPS`` rows:

- the start states are equal (the port's from ``build_cold_reanalysis``
  at full width, cut to the columns);
- both leave the range (``chip_smoke._sound_columns``: a non-finite value,
  or vartheta_l outside [0, 1]) in the same columns, each within
  ``STEP_SLACK`` steps of the other, and not before ``FIRST_STEP``: after
  the chip's cut, so that phase 17b's steps stay clear of it;
- the column outside the band stays in range in both;
- while both are in range their states agree to ``AGREE_RTOL`` of each
  field's largest value (f64 rounding, amplified as the column turns
  unstable).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu import (
    Column as JColumn,
    PrescribedAtmosForcing as JAtmos,
    SoilColumnBC as JSoilColumnBC,
    SoilComponentBC as JSoilComponentBC,
    SoilEnergyModel as JSoilEnergyModel,
    SoilHydrologyModel as JSoilHydrologyModel,
    SoilModel as JSoilModel,
    SoilParams as JSoilParams,
    VerticalFlux as JVerticalFlux,
)
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models import land as jland
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JFreezeThaw
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity as j_vhc
from landhydrology_tpu.models.soil.heat import volumetric_internal_energy as j_vie
from landhydrology_tpu.runtime import make_forced_segment_run as j_forced_segment
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ, NCOL, DT = cs.FORCED_NZ, cs.FORCED_NCOL, cs.FORCED_DT
#: rain band columns of the full-width run that leave the range, and one the band has not reached
DIVERGING, STABLE = (360, 488, 1136, 1704), 20000
STEPS, FIRST_STEP, STEP_SLACK, AGREE_RTOL = 84, 60, 8, 1e-6


def jax_cold_reanalysis(setting, columns):
    """``build_cold_reanalysis`` built with the JAX package, on the full
    width's ``columns``: its start state and the model."""
    soil = JSoilModel(
        domain=JColumn(zlim=(-2.0, 0.0), nelements=NZ, batch_shape=(len(columns),)),
        energy_model=JSoilEnergyModel(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=JvanGenuchten(n=2.0, alpha=2.6, Ksat=3e-7,
                                                                           theta_r=0.05)),
        boundary_conditions=JSoilColumnBC(
            top=JAtmos(u_atm=2.0, theta_atm=294.0, z_atm=2.0, theta_scale=294.0, rho_a_sfc=1.2, q_atm=0.004),
            bottom=JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0))),
        soil_param_set=JSoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6), dtype=jnp.float64,
        freeze_thaw=JFreezeThaw(tau=cs.COLD_FORCED_TAU),
        coefficient_update="step" if setting.startswith("B2+") else "stage",
    )
    land = jland.LandModel(soil=soil, surface=jland.SurfaceWaterModel(tau_pond=600.0),
                           surface_update="step" if "-step" in setting else "stage")
    T = 273.4 + 2.0 * np.asarray(columns, dtype=np.float64)[None, :] / NCOL

    def ic(z, m):
        th = jnp.full((NZ, len(columns)), 0.18)
        ti = jnp.zeros_like(th)
        return {"vartheta_l": th, "theta_i": ti,
                "rho_e_int": j_vie(ti, j_vhc(th, ti, 1.3e6, jps), jnp.broadcast_to(jnp.asarray(T), th.shape), jps)}

    Y, Ya = jland.initialize_states(land, ic, 0.0, h_s0=0.0)
    return land, Y, Ya


def _np_state(Y):
    out = {k: np.asarray(v, dtype=np.float64) for k, v in Y["soil"].items()}
    out["h_s"] = np.asarray(Y["surface"]["h_s"], dtype=np.float64)[None, :]
    return out


@pytest.mark.parametrize("setting", cs.COLD_FORCED_PATHS)
def test_rain_on_frozen_ground_leaves_the_range_in_jax_at_the_same_step(setting):
    columns = list(DIVERGING) + [STABLE]
    times, rows = cs.reanalysis_forcing(STEPS, NCOL, DT)
    rows["theta_atm"] = rows["theta_atm"] - np.float32(cs.COLD_FORCED_SHIFT)
    rows = {k: v[:, columns].astype(np.float64) for k, v in rows.items()}
    fields = tuple(rows)

    land, Y0, _ = cs.build_cold_reanalysis(NZ, NCOL, torch.float64, "cpu", setting)
    idx = torch.as_tensor(columns)
    sub, Yp = cs.column_slice(land.soil, {"soil": Y0["soil"]}, idx)
    Yp["surface"] = {"h_s": Y0["surface"]["h_s"][idx].contiguous()}
    port = dataclasses.replace(land, soil=sub)
    jm, Yj, Yaj = jax_cold_reanalysis(setting, columns)
    start_p, start_j = _np_state(Yp), _np_state(Yj)
    for k in start_p:
        np.testing.assert_allclose(start_p[k], start_j[k], rtol=1e-15, atol=0, err_msg=k)

    step_j = j_forced_segment(jm, JSSPRK33(), dt=DT, field_names=fields, engine="xla")
    left = {"jax": {}, "port": {}}
    t = 0.0
    for i in range(STEPS):
        row = {k: v[i:i + 1] for k, v in rows.items()}
        Yj, _ = step_j(Yj, Yaj, t, {k: jnp.asarray(v) for k, v in row.items()})
        Yp = ck.fused_column_run_plain(port, SSPRK33(), DT, 1, Yp, t,
                                       forcing={k: torch.as_tensor(v) for k, v in row.items()})
        t += DT
        sj, sp = _np_state(Yj), _np_state(Yp)
        sound = {"jax": cs._sound_columns(sj), "port": cs._sound_columns(sp)}
        for who, ok in sound.items():
            for j in np.flatnonzero(~ok):
                left[who].setdefault(columns[j], i + 1)
        both = sound["jax"] & sound["port"]
        for k in sj:
            scale = float(np.max(np.abs(sj[k][:, both]))) if both.any() else 0.0
            dev = float(np.max(np.abs(sj[k][:, both] - sp[k][:, both]))) if both.any() else 0.0
            assert dev <= AGREE_RTOL * scale, f"step {i + 1} {k}: {dev:.3e} of {scale:.3e}"
    print(f"{setting}: steps at which each column left the range: JAX {left['jax']}, port {left['port']}")
    assert set(left["jax"]) == set(left["port"]) == set(DIVERGING)
    for c in DIVERGING:
        assert min(left["jax"][c], left["port"][c]) >= FIRST_STEP > cs.COLD_FORCED_STEPS
        assert abs(left["jax"][c] - left["port"][c]) <= STEP_SLACK
