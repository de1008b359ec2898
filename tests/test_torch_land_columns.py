"""Per-column BC kinds and geometry in the land modes (kernel modes
B1-batched and B8 under a MOST top or a LandModel, ``MODE_COLUMNS``:
``csrc/land_columns_kernel.cu`` and ``csrc/land_policy_columns_kernel.cu``
under all four explicit steppers, ``csrc/land_kernel.cu``'s SSPRK33 B5 and
B6) through the kernel's plain version, against the JAX package's fused
kernel in interpret mode.

- ``experiments/soil/catchment.py``'s soil and storm without routing, at its
  own regolith depth per column (0.5-2 m, ``VariableDepthColumn``): the
  ridge/valley terrain on 4 x 2 columns (flattened in row-major order), the
  per-column vanGenuchten, nz=6, 4 steps of 2 s from t = 1,700 s (before the
  storm's peak), as ``B6-pond-water+B8`` and ``B2+B6-step-pond-water+B8``
  (a pond must form), and its ``--atmos`` variant (a coupled soil under
  MOST from 292 K) as ``B2+B6-step+B8``.
- f64 at rtol 1e-12 (atol 1e-16, the pond 1e-18), one tile.
- A check of all 48 land modes without JAX: each takes kinds, geometry and
  forcing rows, names its instance and source; the implicit steppers under a
  MOST top still refuse them (ROADMAP B1-batched, B8), and TR-BDF2 on the
  heat-only branch (not queued).

The cold policy instances, the no-ice cap and the other steppers are in
``test_torch_land_columns_policies.py``.  The kernels are held against this
plain version on the card in ``chip_smoke.py`` phase 19 and by the
``cuda``-marked tests here, which skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedAtmosForcing as JAtmos
from landhydrology_tpu import PrescribedTemperatureModel as JPrescribedT
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import SoilEnergyModel as JSoilEnergy
from landhydrology_tpu import SoilHydrologyModel as JSoilHydrology
from landhydrology_tpu import SoilModel as JSoilModel
from landhydrology_tpu import SoilParams as JSoilParams
from landhydrology_tpu import VariableDepthColumn as JVariableDepth
from landhydrology_tpu import VerticalFlux as JVerticalFlux
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models import land as jland
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch import timestepping as ts
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_land_policies_b5 import assert_matches, cuda_device  # noqa: F401

#: catchment.py's storm for its default 2 h run: 40 mm/h at t = 1,800 s, width 576 s
STORM_PEAK, STORM_T_C, STORM_SIG = 40.0 / 1000.0 / 3600.0, 1800.0, 576.0
#: the catchment cases: 4 x 2 columns, nz=6, 4 steps of 2 s from t = 1,700 s
NX, NY, CATCHMENT_NZ, CATCHMENT_DT, CATCHMENT_STEPS, CATCHMENT_T0 = 4, 2, 6, 2.0, 4, 1700.0
#: (name, lagged, frozen exchange, --atmos) of the catchment cases
CATCHMENT_CASES = (("B6-pond-water+B8", False, False, False), ("B2+B6-step-pond-water+B8", True, True, False),
                   ("B2+B6-step+B8", True, True, True))


def storm(t):
    """The storm's rain rate (m/s) at ``t``, for JAX arrays and tensors."""
    x = -(((t - STORM_T_C) / STORM_SIG) ** 2)
    return STORM_PEAK * (x.exp() if torch.is_tensor(x) else jnp.exp(x))


def jax_catchment(lagged=False, step=False, atmos=False):
    """``catchment.py:87-180``'s LandModel, flattened to ``NX * NY`` columns,
    without its routing (a cross-column stencil, eager only in both
    packages), and its start state: water 0.15, no ice, no pond (``atmos``:
    the coupled soil under its MOST top at 292 K).  Returns ``(JAX model,
    JAX state)``."""
    ix, iy = np.arange(NX)[:, None], np.arange(NY)[None, :]
    z = 4.0 * (1.0 + np.cos(2 * np.pi * ix / NX)) * np.ones((1, NY)) + 0.3 * np.sin(
        2 * np.pi * iy / NY) * np.sin(2 * np.pi * ix / NX)
    z_norm = (z - z.min()) / (z.max() - z.min())
    depth = 0.5 + 1.5 * (1.0 - z_norm)
    log_ksat = -6.5 + 1.2 * z_norm + 0.15 * np.random.default_rng(42).standard_normal((NX, NY))
    flat = lambda a: jnp.asarray(np.reshape(a, -1))  # noqa: E731
    hm = JvanGenuchten(n=flat(1.8 + 1.2 * z_norm), alpha=flat(2.0 + 1.5 * z_norm), Ksat=flat(10.0 ** log_ksat),
                       theta_r=0.05)
    energy, top = JPrescribedT(), JSoilComponentBC(hydrology=JVerticalFlux(0.0))
    bottom = JSoilComponentBC(hydrology=JVerticalFlux(0.0))
    if atmos:
        energy = JSoilEnergy()
        top = JAtmos(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2, q_atm=0.006)
        bottom = JSoilComponentBC(hydrology=JVerticalFlux(0.0), energy=JVerticalFlux(0.0))
    ncol, nz = NX * NY, CATCHMENT_NZ
    soil = JSoilModel(
        domain=JVariableDepth(z_bottom=flat(-depth), nelements=nz, batch_shape=(ncol,)), energy_model=energy,
        hydrology_model=JSoilHydrology(hydraulic_model=hm), boundary_conditions=JSoilColumnBC(top=top, bottom=bottom),
        soil_param_set=JSoilParams(nu=0.42, S_s=1e-3, rho_c_ds=1.3e6), dtype=jnp.float64,
        coefficient_update="step" if lagged else "stage")
    jm = jland.LandModel(soil=soil, surface=jland.SurfaceWaterModel(precipitation=storm, tau_pond=600.0),
                         surface_update="step" if step else "stage")
    theta = np.full((nz, ncol), 0.15)
    Y = {"soil": {"vartheta_l": jnp.asarray(theta), "theta_i": jnp.zeros((nz, ncol))},
         "surface": {"h_s": jnp.zeros(ncol)}}
    if atmos:
        rho_c_s = volumetric_heat_capacity(theta, np.zeros_like(theta), 1.3e6, jps)
        Y["soil"]["rho_e_int"] = volumetric_internal_energy(jnp.zeros((nz, ncol)), rho_c_s,
                                                            jnp.full((nz, ncol), 292.0), jps)
    return jm, Y


def jax_reference(jm, stepper, dt, steps, Y, t0, forcing=None):
    """JAX's fused kernel in interpret mode over one tile (``tile_cols`` =
    the column count), compiled once by ``jax.jit``; the final state as
    numpy arrays."""
    ncol = Y["soil"]["vartheta_l"].shape[1]
    run = jax_fused(jm, stepper, dt=dt, steps_per_call=steps, tile_cols=ncol, interpret=True,
                    forcing_fields=tuple(forcing or ()))
    out = jax.jit(run)(Y, t0, forcing=forcing)
    return jax.tree_util.tree_map(np.asarray, out)


def run_port(jm, stepper, dt, steps, Y, t0, name, source, forcing=None):
    """The port's fused run of the JAX model ``jm`` (its plain version on
    the CPU, no launch) under ``stepper`` (a name of the port's
    ``timestepping``) from the JAX state ``Y``; checks the run's name and
    the source of its instance.  Returns the final state as numpy arrays."""
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, getattr(ts, stepper)(), dt=dt, steps_per_call=steps,
                                   forcing_fields=tuple(forcing or ()))
    assert run.name == name
    assert ck._entry(run.mode, torch.float64)[0] == source
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    rows = None if forcing is None else {k: torch.as_tensor(v) for k, v in forcing.items()}
    assert run(Yt, t0, forcing=rows) is Yt and ck.LAUNCHES == before
    return state_to_numpy(Yt)


@pytest.mark.parametrize("case", CATCHMENT_CASES, ids=lambda c: c[0])
def test_catchment_storm_at_its_regolith_depth_matches_jax_fused(case):
    """catchment.py's LandModel at its varying depth (no routing) on the
    fused engine equals JAX's fused kernel at rtol 1e-12; a pond forms, and
    the water moves."""
    name, lagged, step, atmos = case
    jm, Y = jax_catchment(lagged, step, atmos)
    depths = -np.asarray(jm.soil.domain.z_bottom)
    assert depths.min() == pytest.approx(0.5) and depths.max() == pytest.approx(2.0)
    ref = jax_reference(jm, jts.SSPRK33(), CATCHMENT_DT, CATCHMENT_STEPS, Y, CATCHMENT_T0)
    got = run_port(jm, "SSPRK33", CATCHMENT_DT, CATCHMENT_STEPS, Y, CATCHMENT_T0, name, "land_columns_kernel")
    assert_matches(got, ref, jm)
    assert float(ref["surface"]["h_s"].max()) > 1e-5  # a pond formed
    change = np.abs(ref["soil"]["vartheta_l"] - np.asarray(Y["soil"]["vartheta_l"]))
    assert float(change.max()) > 1e-6


def test_catchment_runs_on_the_fused_engine():
    """``Simulation(engine="fused")`` runs the catchment LandModel at its
    depths in one launch's plain version per call, and equals the fused
    run."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.domains import make_function_space

    jm, Y = jax_catchment()
    model = model_from_reference(jm, device="cpu")
    Yt = state_from_numpy(Y, device="cpu")
    grid = make_function_space(model.soil.domain, torch.float64, "cpu")
    assert tuple(grid.zc.shape) == (CATCHMENT_NZ, NX * NY)
    sim = Simulation(model, ts.SSPRK33(), Y_init=Yt, Ya_init={"zc": grid.zc, "soil": {}}, dt=CATCHMENT_DT,
                     tspan=(CATCHMENT_T0, CATCHMENT_T0 + CATCHMENT_STEPS * CATCHMENT_DT), engine="fused",
                     steps_per_call=CATCHMENT_STEPS // 2)
    sim.run()
    got = run_port(jm, "SSPRK33", CATCHMENT_DT, CATCHMENT_STEPS, Y, CATCHMENT_T0, "B6-pond-water+B8",
                   "land_columns_kernel")
    for group, fields in got.items():
        for k, v in fields.items():
            np.testing.assert_array_equal(sim.Y[group][k].numpy(), v, err_msg=f"{group}/{k}")


# ---- all 48 land modes, without JAX ----


def test_every_land_mode_takes_kinds_geometry_and_rows():
    """Each of the 48 land modes (``chip_smoke.LAND_RK_MODES``) builds a run
    with per-column kinds, with per-column geometry and with both and
    forcing rows, under each explicit stepper: its name ends in ``+kinds``
    / ``+B8`` (then ``+B7`` and the stepper), and it launches from
    ``land_columns_kernel`` / ``land_policy_columns_kernel``, but SSPRK33 in
    B5 and B6 from ``land_kernel``'s fixed stages."""
    import chip_smoke as cs

    modes = cs.LAND_RK_MODES
    assert len(set(modes)) == 48
    names = set()
    for name in modes:
        model, Y, _, _, _ = cs.policy_variant(name, torch.float64, "cpu")
        for kinds, depth in ((True, False), (False, True), (True, True)):
            variant = cs.with_columns(model, 3, kinds=kinds, depth=depth)
            rows = tuple(cs.policy_rows(variant, 2, seed=1)) if kinds and depth else ()
            for stepper in ("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104"):
                run = ck.make_fused_column_run(variant, getattr(ts, stepper)(), forcing_fields=rows)
                suffix = ("+kinds" if kinds else "") + ("+B8" if depth else "") + ("+B7" if rows else "")
                assert run.name == name + suffix + ("" if stepper == "SSPRK33" else "@" + stepper)
                assert run.mode & ck.MODE_COLUMNS and ck.takes_per_column(run.mode)
                lib = ck._entry(run.mode, torch.float32)[0]
                if stepper == "SSPRK33" and name in ("B5", "B6"):
                    assert lib == "land_kernel"
                else:
                    policy = any(p in name for p in ("+B3-rate", "+B3-eq", "-no-ice"))
                    assert lib == ("land_policy_columns_kernel" if policy else "land_columns_kernel")
                names.add(ck.mode_name(run.mode & ~ck.MODE_RK))
    assert len(names) == 48  # one MODE_COLUMNS instance per mode


def _refused_variant(name, what):
    """A port model of mode ``name`` with per-column kinds (``what`` is
    ``"kinds"``) or depths, and its stepper: ``chip_smoke.policy_variant``'s
    MOST soil under the implicit stepper of ``B4-<stepper>+B5``, or golden
    #1's column on the heat-only branch under TR-BDF2 for
    ``B4-trbdf2-heat``."""
    import chip_smoke as cs
    from tests.data import golden_config_torch as gct

    from landhydrology_tpu_torch import PrescribedHydrologyModel, SoilColumnBC, SoilComponentBC

    stepper = {"trbdf2": "TRBDF2Soil", "be-soil": "BackwardEulerSoil", "be-richards": "BackwardEulerRichards"}[
        name[3:].split("+")[0].split("-heat")[0]]
    if name == "B4-trbdf2-heat":
        model = gct.build_model_and_state(torch.float64, "cpu")[0]
        bcs = model.boundary_conditions
        model = dataclasses.replace(model, hydrology_model=PrescribedHydrologyModel(), boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=bcs.top.energy), bottom=SoilComponentBC(energy=bcs.bottom.energy)))
    else:
        model = cs.policy_variant("B5", torch.float64, "cpu")[0]
    variant = cs.with_columns(model, 3, kinds=what == "kinds", depth=what != "kinds")
    return variant, cs.implicit(stepper, variant, 2)


@pytest.mark.parametrize("name,what,item", [("B4-trbdf2+B5", "kinds", "B1-batched"), ("B4-trbdf2+B5", "depth", "B8"),
                                            ("B4-be-soil+B5", "kinds", "B1-batched"),
                                            ("B4-be-richards+B5", "depth", "B8"),
                                            ("B4-trbdf2-heat", "kinds", "B1-batched, not queued")])
def test_modes_outside_the_lists_still_refuse(name, what, item):
    """Per-column kinds or geometry stay refused only in TR-BDF2 on the
    heat-only branch, which is not queued (the reference's TRBDF2Soil cannot
    run that branch), naming ``item``.  The implicit steppers under a MOST
    top, with forcing rows or without, take them since queue B item 2's
    remainder (B1-batched, B8): their runs are named ``<mode>+kinds`` or
    ``<mode>+B8`` (``+B7`` with rows) and launch
    ``implicit_most_columns_kernel``'s instances."""
    variant, stepper = _refused_variant(name, what)
    mode = ck.kernel_mode(variant, stepper)
    rows = ({},) + (({"forcing_fields": ("theta_atm",)},) if name.endswith("+B5") else ())
    if name.endswith("+B5"):
        assert ck.takes_per_column(mode) and ck._entry(mode, torch.float64)[0] == "implicit_most_columns_kernel"
        for kw in rows:
            suffix = ("+kinds" if what == "kinds" else "+B8") + ("+B7" if kw else "")
            assert ck.make_fused_column_run(variant, stepper, **kw).name == name + suffix
        return
    assert not ck.takes_per_column(mode)
    for kw in rows:
        with pytest.raises(NotImplementedError, match=rf"in mode {name.replace('+', '[+]')}.*ROADMAP {item}\)"):
            ck.make_fused_column_run(variant, stepper, **kw)


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("name,stepper", [("B2+B6-step-pond-water", "SSPRK33"), ("B6-pond", "ForwardEuler"),
                                          ("B2+B6-step+B3-rate", "SSPRK104"), ("B5-no-ice", "SSPRK22")])
def test_cuda_column_instances_match_plain(cuda_device, name, stepper):  # noqa: F811
    """A launch of each new source's instances (``land_columns_kernel``,
    ``land_policy_columns_kernel``) with kinds, geometry and rows against
    the plain version on the card, f64 at the bar of ``assert_matches``."""
    import chip_smoke as cs

    model, Y, _, dt, steps = cs.policy_variant(name, torch.float64, cuda_device)
    model = cs.with_columns(model, 5)
    rows = cs.policy_rows(model, steps, seed=3)
    st = getattr(ts, stepper)()
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, dt, steps, Y, 5.0, forcing=rows))
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=steps, forcing_fields=tuple(rows))
    before = ck.LAUNCHES[run.name]
    run(Y, 5.0, forcing=rows)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    for group, fields in plain.items():
        for k, v in fields.items():
            np.testing.assert_allclose(Y[group][k].cpu().numpy(), v, rtol=1e-12, atol=1e-16, err_msg=f"{group}/{k}")
