"""The pieces of ``chip_smoke.py`` that run without a GPU.

``build_bench_model`` rebuilds ``bench.py::build`` with the port's API; it
is held here against the JAX builder (state and rhs, rtol 1e-13 in
float64).  ``_check_increment`` is the check that lets the f32 main path
fail a kernel that changes the state too little; it is held here to accept
the plain version and to reject a kernel that does nothing, one that takes
a third of the steps and one that drops the water tendency, at the
benchmark's depth and a narrow width, in both dtypes, and, in f64, a kernel
that recomputes the lagged coefficients in every stage.  The freeze-thaw
builder at width and the operation counts behind each kernel's bound are
checked too.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke as cs
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ, NCOL = 64, 32
MOVING = ("vartheta_l", "rho_e_int")


def test_bench_model_matches_jax_builder():
    jmodel, jY, jYa = bench.build(16, NCOL, jnp.float64)
    model, Y, Ya = cs.build_bench_model(16, NCOL, torch.float64, "cpu")
    ref_state = {k: np.asarray(v) for k, v in jY["soil"].items()}
    for k, v in cs._np(Y).items():
        np.testing.assert_allclose(v, ref_state[k], rtol=1e-13, atol=0, err_msg=k)
    ref = jax_make_rhs(jmodel)(jY, jYa, jnp.asarray(3.0, dtype=jnp.float64))
    got = make_rhs(model)(Y, Ya, torch.tensor(3.0, dtype=torch.float64))
    for k, v in cs._np(got).items():
        r = np.asarray(ref["soil"][k])
        scale = float(np.max(np.abs(r)))
        np.testing.assert_allclose(v, r, rtol=1e-13, atol=1e-13 * scale, err_msg=k)


@functools.lru_cache(maxsize=None)
def _runs(dtype):
    """(start, after 96 steps, after 32 steps) of the benchmark model."""
    model, Y0, _ = cs.build_bench_model(NZ, NCOL, dtype, "cpu")
    states, Y, t = [], Y0, torch.as_tensor(0.0, dtype=dtype)
    for _ in range(cs.N_STEPS // cs.SPC):
        Y = ck.fused_column_run_plain(model, SSPRK33(), cs.DT, cs.SPC, Y, t)
        t = t + cs.SPC * torch.as_tensor(cs.DT, dtype=dtype)
        states.append(cs._np(Y))
    return cs._np(Y0), states[-1], states[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_increment_check_accepts_the_plain_version(dtype):
    start, plain, _ = _runs(dtype)
    shares = cs._check_increment(plain, plain, start, dtype, "plain", MOVING)
    assert shares == {"vartheta_l": 0.0, "rho_e_int": 0.0}


@pytest.mark.parametrize("mutation", ["no_op", "third_of_the_steps", "no_water_tendency"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_increment_check_fails_kernels_that_change_too_little(dtype, mutation):
    start, plain, third = _runs(dtype)
    kern = {
        "no_op": start,
        "third_of_the_steps": third,
        "no_water_tendency": dict(plain, vartheta_l=start["vartheta_l"]),
    }[mutation]
    with pytest.raises(AssertionError, match="vartheta_l: change differs"):
        cs._check_increment(kern, plain, start, dtype, mutation, MOVING)


def test_increment_check_fails_a_per_stage_kernel_in_f64():
    """In f64 the lagged main path's change bar tells the lagged trajectory
    from the stage one: a kernel that recomputed the coefficients in every
    stage fails it (in f32 the two can agree to rounding)."""
    model, Y0, _ = cs.build_bench_model(NZ, NCOL, torch.float64, "cpu")
    lagged = dataclasses.replace(model, coefficient_update="step")
    ends = {}
    for m in (model, lagged):
        Y, t = Y0, torch.as_tensor(0.0, dtype=torch.float64)
        for _ in range(cs.N_STEPS // cs.SPC):
            Y = ck.fused_column_run_plain(m, SSPRK33(), cs.DT, cs.SPC, Y, t)
            t = t + cs.SPC * cs.DT
        ends[m.coefficient_update] = cs._np(Y)
    start = cs._np(Y0)
    cs._check_increment(ends["step"], ends["step"], start, torch.float64, "lagged", MOVING)
    with pytest.raises(AssertionError, match="change differs"):
        cs._check_increment(ends["stage"], ends["step"], start, torch.float64, "per-stage", MOVING)


def test_freeze_wide_builder(monkeypatch):
    """The freeze golden's column at the main path's width, with moisture
    and temperature varied by column, under either scheme."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    monkeypatch.setattr(cs, "NZ", 8)
    monkeypatch.setattr(cs, "NCOL", 16)
    gc = cs._load_golden_config()
    model, Y, Ya, dt = cs.build_freeze_wide(gc, torch.float64, "cpu", EquilibriumFreezeThaw())
    assert isinstance(model.freeze_thaw, EquilibriumFreezeThaw) and dt == 5.0
    assert model.domain.nelements == 8 and model.domain.batch_shape == (16,)
    state = cs._np(Y)
    assert all(Y["soil"][k].is_contiguous() and v.shape == (8, 16) for k, v in state.items())
    assert np.all(np.diff(state["vartheta_l"][0]) > 0) and np.all(state["theta_i"] == 0)
    assert len(np.unique(state["rho_e_int"][0])) == 16 and tuple(Ya["zc"].shape) == (8, 1)


def test_bound_counts_and_selection():
    """The operation counts follow the modes (lagged coefficients drop exp
    and log calls, the projection adds 2 pow per bisection round), and the
    bound takes the larger of the bytes and the operations."""
    ops = {mode: cs.cell_step_ops(ck, mode) for mode in (0, ck.MODE_LAGGED, ck.MODE_NO_ICE,
                                                          ck.MODE_FREEZE_RATE, ck.MODE_FREEZE_EQ)}
    assert ops[ck.MODE_LAGGED]["exp"] < ops[0]["exp"] and ops[ck.MODE_NO_ICE]["exp"] < ops[0]["exp"]
    assert ops[ck.MODE_FREEZE_RATE]["pow"] == 6
    assert ops[ck.MODE_FREEZE_EQ]["pow"] - cs.cell_step_ops(ck, ck.MODE_FREEZE_EQ, n_iter=30)["pow"] == 60
    costs = {torch.float32: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    ms, by = cs.bound_ms(ck, costs, 0, torch.float32, NZ * NCOL, 32)
    assert by == "operations" and ms > 0
    ms1, by1 = cs.bound_ms(ck, costs, 0, torch.float32, NZ * NCOL, 0)
    assert by1 == "bytes" and ms1 == pytest.approx(1e3 * 6 * 4 * NZ * NCOL / cs.HBM_BYTES_PER_S)


def test_freeze_bars_follow_the_bisection_resolution():
    """The equilibrium scheme's extra bar is two ulps of T_0 times the
    steepest slope of the freezing curve (about 44 per K for the freeze
    column's soil): a few 1e-12 in f64, a few 1e-3 in f32.  The rate scheme
    adds nothing, and a partition off by more than the bar fails."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    gc = cs._load_golden_config()
    for dtype, lo, hi in ((torch.float64, 3e-12, 8e-12), (torch.float32, 2e-3, 4e-3)):
        rate, Y, _, _ = gc.build_freeze_model_and_state(dtype, "cpu")
        plain = cs._np(Y)
        assert cs._check_freeze(plain, plain, rate, dtype, "rate") == (0.0, 0.0)
        eq = dataclasses.replace(rate, freeze_thaw=EquilibriumFreezeThaw())
        water, energy = cs._check_freeze(plain, plain, eq, dtype, "eq")
        assert lo < water < hi and energy == pytest.approx(1e3 * eq.earth_param_set.LH_f0 * water)
        off = dict(plain, theta_i=plain["theta_i"] + 3 * water)
        with pytest.raises(AssertionError, match="theta_i"):
            cs._check_freeze(off, plain, eq, dtype, "eq")


# ---- the stiff path's builders, the implicit modes' bounds and traffic ----


def test_stiff_builder_matches_bench():
    """``build_stiff`` rebuilds ``bench.py::build_stiff`` (state and rhs,
    f64 rtol 1e-13), and ``stiff_dt_explicit`` is bench.py's ``dt_exp``."""
    from landhydrology_tpu.diagnostics import explicit_dt_limit as jax_dt_limit

    jmodel, jY, jYa = bench.build_stiff(16, NCOL, jnp.float64)
    model, Y, Ya = cs.build_stiff(16, NCOL, torch.float64, "cpu")
    for k, v in cs._np(Y).items():
        np.testing.assert_allclose(v, np.asarray(jY["soil"][k]), rtol=1e-13, atol=0, err_msg=k)
    ref = jax_make_rhs(jmodel)(jY, jYa, jnp.asarray(3.0, dtype=jnp.float64))["soil"]["vartheta_l"]
    got = make_rhs(model)(Y, Ya, torch.tensor(3.0, dtype=torch.float64))["soil"]["vartheta_l"]
    scale = float(np.max(np.abs(np.asarray(ref))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-13 * scale)
    # bench.py:579-590
    front = jnp.where((jnp.arange(16) % 2)[:, None] == 0, 0.1, 0.267).astype(jnp.float64)
    wet = {"soil": dict(jY["soil"], vartheta_l=jnp.broadcast_to(front, (16, NCOL)))}
    want = 0.5 * float(jax_dt_limit(jmodel, wet))
    assert cs.stiff_dt_explicit(model, Y) == pytest.approx(want, rel=1e-12)


def test_heat_only_builder():
    """The heat-only column: one contiguous prognostic field, prescribed
    moisture and ice, a callable Dirichlet top and (with a seed) a
    per-column bottom flux; the B1-heat plain run moves rho_e_int."""
    model, Y, Ya = cs.build_heat_only(16, NCOL, torch.float64, "cpu", seed=3)
    assert list(Y["soil"]) == ["rho_e_int"] and Y["soil"]["rho_e_int"].is_contiguous()
    assert ck.mode_name(ck.kernel_mode(model)) == "B1-heat"
    assert tuple(model.boundary_conditions.bottom.energy.flux.shape) == (NCOL,)
    start = cs._np(Y)
    end = cs._np(ck.fused_column_run_plain(model, SSPRK33(), 10.0, 4, Y, 0.0))
    assert np.max(np.abs(end["rho_e_int"] - start["rho_e_int"])) > 1e3


def test_implicit_bound_counts():
    """The implicit modes' operation counts follow the stepper: TR-BDF2
    evaluates the rhs 1 + 2 iters times per active component, a coupled
    water sweep's rhs leaves out kappa, PCR adds its levels to each solve,
    and the heat-only branch moves one state field."""
    water = ck.MODE_TRBDF2 | ck.MODE_WATER
    psi_hyd_exp = 4  # exp calls of pressure_head + conductivity per rhs
    for iters in (1, 2, 3):
        ops = cs.cell_step_ops(ck, water, iters=iters)
        assert ops["exp"] == psi_hyd_exp * (1 + 2 * iters) + 2 * 2 * iters  # + dpsi per sweep
    thomas, pcr = cs.cell_step_ops(ck, water), cs.cell_step_ops(ck, water | ck.MODE_PCR)
    assert pcr["op"] > thomas["op"] and pcr["div"] > thomas["div"] and pcr["exp"] == thomas["exp"]
    coupled = cs.cell_step_ops(ck, ck.MODE_TRBDF2)
    assert coupled["exp"] > thomas["exp"] > cs.cell_step_ops(ck, ck.MODE_BE_RICHARDS | ck.MODE_WATER)["exp"]
    # coupled: f(u^n) and the heat sweeps take the full closures (5 exp) and
    # psi (2); a water sweep's rhs needs no kappa, so K and psi alone (4)
    full, water_sweep, dpsi = 5 + 2, psi_hyd_exp, 2
    assert coupled["exp"] == full * (1 + 2 * 2) + (water_sweep + dpsi) * 2 * 2
    assert cs.cell_step_ops(ck, ck.MODE_BE_RICHARDS)["exp"] == (water_sweep + dpsi) * 2 + full
    assert cs.cell_step_ops(ck, ck.MODE_BE_SOIL)["exp"] == (water_sweep + dpsi) * 2 + full * 2
    assert (cs.cell_step_ops(ck, ck.MODE_BE_RICHARDS)["op"] - cs.cell_step_ops(ck, ck.MODE_BE_RICHARDS | ck.MODE_WATER)["op"]
            == 2 * cs._TEMP["op"] + 51 + 13 + 21)  # T per water sweep, then the explicit full rhs
    assert cs.cell_step_ops(ck, ck.MODE_BE_SOIL)["op"] > cs.cell_step_ops(ck, ck.MODE_BE_RICHARDS)["op"]
    assert [cs.state_fields(ck, m) for m in (0, ck.MODE_WATER, ck.MODE_HEAT)] == [3, 2, 1]
    costs = {torch.float64: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    ms, by = cs.bound_ms(ck, costs, ck.MODE_TRBDF2 | ck.MODE_HEAT, torch.float64, NZ * NCOL, 0)
    assert by == "bytes" and ms == pytest.approx(1e3 * 2 * 8 * NZ * NCOL / cs.HBM_BYTES_PER_S)


def test_scratch_traffic_counts():
    """Values per cell-step through the implicit kernel's scratch: a Thomas
    sweep moves 20 (water-only: 2 state loads, F/K/C stores, 11 in the
    assembly and elimination, 4 in the back substitution), PCR adds 16 per
    level, and TR-BDF2 runs 2 stages of ``iters`` sweeps."""
    water = ck.MODE_TRBDF2 | ck.MODE_WATER
    thomas = cs.scratch_values_per_cell_step(ck, water, iters=2)
    assert thomas == 2 + 4 + 2 * 2 * (20 + 2) + 6 + 4
    pcr = cs.scratch_values_per_cell_step(ck, water | ck.MODE_PCR, iters=2)
    assert pcr - thomas == 2 * 2 * (4 + 16 * 6 + 4 - 4 - 2)
    be = cs.scratch_values_per_cell_step(ck, ck.MODE_BE_RICHARDS | ck.MODE_WATER, iters=2)
    assert be == 2 * 20 + 4
    assert cs.scratch_values_per_cell_step(ck, ck.MODE_BE_SOIL) > cs.scratch_values_per_cell_step(
        ck, ck.MODE_BE_RICHARDS)


def test_registers_and_sources_of_both_kernels(tmp_path):
    """The ptxas report parser names the instances of both kernels by mode,
    and each mode's kernel record names the source that holds it."""
    report = (
        "ptxas info    : Compiling entry function '_ZN_ssprk33_column_kernelIfLi16EEEv10KernelArgs' for 'sm_90a'\n"
        "ptxas info    : Used 90 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN_implicit_column_kernelIdLi272EEEv10KernelArgs' for 'sm_90a'\n"
        "ptxas info    : Used 218 registers, used 0 barriers\n"
    )
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == "implicit_kernel" else "")
    assert cs.registers(ck, libs) == {"f32, B1-water": 90, "f64, B4-trbdf2-water": 218}
    kernel, source = cs.kernel_of(ck, ck.MODE_TRBDF2 | ck.MODE_PCR, torch.float64)
    assert kernel == "implicit_column_kernel" and source == "landhydrology_tpu_torch/csrc/implicit_kernel.cu"
    kernel, source = cs.kernel_of(ck, ck.MODE_HEAT, torch.float32)
    assert kernel == "ssprk33_column_kernel" and source == "landhydrology_tpu_torch/csrc/column_kernel.cu"


# ---- the land path's builders and the surface modes' bounds ----


@pytest.mark.parametrize("setting", ["reference", "production"])
def test_land_builder_matches_bench(setting):
    """``build_land_model`` rebuilds ``bench.py::build_land`` (state, pond
    and land rhs, f64 rtol 1e-13) in the reference (B6) and production
    (B2+B6-step) settings."""
    from landhydrology_tpu.models.land import make_rhs as jax_land_rhs
    from landhydrology_tpu_torch.models.land import make_rhs as land_rhs

    kw = {} if setting == "reference" else {"surface_update": "step", "coefficient_update": "step"}
    jland, jY, jYa = bench.build_land(16, NCOL, jnp.float64, **kw)
    land, Y, Ya = cs.build_land_model(16, NCOL, torch.float64, "cpu", **kw)
    assert ck.mode_name(ck.kernel_mode(land)) == ("B6" if setting == "reference" else "B2+B6-step")
    for k, v in cs._np(Y).items():
        ref = jY["surface"]["h_s"] if k == "h_s" else jY["soil"][k]
        np.testing.assert_allclose(v, np.asarray(ref), rtol=1e-13, atol=0, err_msg=k)
    ref = jax_land_rhs(jland)(jY, jYa, jnp.asarray(3.0, dtype=jnp.float64))
    got = cs._np(land_rhs(land)(Y, Ya, torch.tensor(3.0, dtype=torch.float64)))
    for k, v in got.items():
        r = np.asarray(ref["surface"]["h_s"] if k == "h_s" else ref["soil"][k])
        np.testing.assert_allclose(v, r, rtol=1e-13, atol=1e-13 * float(np.max(np.abs(r))), err_msg=k)


def test_land_variant_and_small_builders():
    """The variants carry per-column atmosphere fields over both Businger
    branches (theta_atm on both sides of the surface temperature) and build
    the mode they name; the JAX fused tests' land configurations build
    B6 and B6-step."""
    for case in ("B5", "B2+B5", "B6", "B6-step", "B2+B6-step", "B6-pond", "B6-step-pond", "B2+B6-pond",
                 "B2+B6-step-pond"):
        model, Y = cs.build_land_variant(64, torch.float64, "cpu", seed=13, case=case)
        assert ck.mode_name(ck.kernel_mode(model)) == case
        assert ("h_s" in cs._np(Y)) == ("B6" in case)
    model, Y = cs.build_land_variant(64, torch.float64, "cpu", seed=13, case="B6")
    atmos = model.soil.boundary_conditions.top
    assert atmos.u_atm.shape == (64,) and callable(atmos.theta_scale)
    from landhydrology_tpu_torch.models.land import _diagnose_state_T

    T = _diagnose_state_T(model.soil, {k: v[-1:] for k, v in Y["soil"].items()}, {})[0]
    d = (atmos.theta_atm - T).numpy()
    assert d.min() < -1.0 and d.max() > 1.0
    land, Y = cs.build_pallas_land(torch.float64, "cpu")
    assert ck.mode_name(ck.kernel_mode(land)) == "B6" and tuple(Y["surface"]["h_s"].shape) == (256,)
    land, Y = cs.build_step_land(torch.float64, "cpu")
    assert ck.mode_name(ck.kernel_mode(land)) == "B6-step" and Y["soil"]["vartheta_l"].is_contiguous()


def test_surface_bound_counts():
    """The surface modes' counts per column and step: the MOST solve counts
    the probes its rounds evaluate (the run's mean, given) with 3 end
    evaluations in f64 and 4 in f32 and one more h for the finish, three
    exchanges per step or one with the frozen exchange; the pond's bytes
    enter the bound; a MOST mode's count needs its probes."""
    most, land = ck.MODE_MOST, ck.MODE_LAND | ck.MODE_MOST
    f64 = cs.column_step_ops(ck, most, torch.float64, probes=97.5)
    f32 = cs.column_step_ops(ck, most, torch.float32, probes=17.0)
    assert f64["sqrt"] == 3 * 8 * (97.5 + 3 + 1) and f32["sqrt"] == 3 * 8 * (17 + 4 + 1)
    full = cs.column_step_ops(ck, most, torch.float64, probes=20 * 8)
    assert full["sqrt"] == 3 * 8 * (20 * 8 + 3 + 1) and full["op"] > f64["op"]
    step = cs.column_step_ops(ck, land | ck.MODE_SURFACE_STEP, torch.float64, probes=100.0)
    stage = cs.column_step_ops(ck, land, torch.float64, probes=100.0)
    assert 3 * step["log"] == stage["log"] and step["pow"] == 1 and stage["pow"] == 3
    assert cs.column_step_ops(ck, ck.MODE_LAND, torch.float64)["sqrt"] == 3 * 1  # the face K alone
    assert not cs.column_step_ops(ck, 0, torch.float64)
    with pytest.raises(ValueError, match="probes"):
        cs.column_step_ops(ck, land, torch.float64)
    costs = {torch.float64: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    ms0, _ = cs.bound_ms(ck, costs, 0, torch.float64, NZ * NCOL, 32, ncol=NCOL)
    ms1, by = cs.bound_ms(ck, costs, land, torch.float64, NZ * NCOL, 32, ncol=NCOL, probes=100.0)
    ms2, _ = cs.bound_ms(ck, costs, land, torch.float64, NZ * NCOL, 32, ncol=NCOL, probes=160.0)
    assert by == "operations" and ms0 < ms1 < ms2
    ms, by = cs.bound_ms(ck, costs, land, torch.float64, NZ * NCOL, 0, ncol=NCOL, probes=100.0)
    assert by == "bytes" and ms == pytest.approx(1e3 * 2 * 8 * (3 * NZ + 1) * NCOL / cs.HBM_BYTES_PER_S)
    assert cs.kernel_of(ck, land, torch.float32) == ("land_column_kernel", "landhydrology_tpu_torch/csrc/land_kernel.cu")


@pytest.mark.parametrize("case", ["B5", "B2+B5", "B6-step", "B2+B6", "B6-pond"])
def test_most_probes_count_one_solve_per_exchange(case):
    """``most_probes`` reads one MOST solve per column and exchange of the
    plain launch (three per step, one with the frozen exchange, none under
    a plain top) and a mean of 1-8 probes per round, below the full 8."""
    model, Y = cs.build_land_variant(32, torch.float64, "cpu", seed=13, case=case)
    solves, probes = cs.most_probes(ck, model, SSPRK33(), 2.0, 2, Y)
    if case == "B6-pond":
        assert (solves, probes) == (0, None)
        return
    assert solves == (2 if "step" in case else 6)
    assert 20 <= probes < 20 * 8
    model32, Y32 = cs.build_land_variant(32, torch.float32, "cpu", seed=13, case=case)
    assert 4 <= cs.most_probes(ck, model32, SSPRK33(), 2.0, 2, Y32)[1] < 4 * 8


# ---- phase 11: the forced-reanalysis path (kernel mode B7) ----


def test_reanalysis_builders_match_the_experiment(tmp_path):
    """``build_reanalysis`` and ``reanalysis_forcing`` rebuild
    ``experiments/soil/forced_reanalysis.py``'s run: at a small size the
    experiment's forcing file (run as a script, JAX on the CPU) is byte for
    byte the port's, and the port's ``run_forced`` on it ends where the
    experiment's float32 run ends (pond, water gain, energy)."""
    import json
    import os
    import subprocess
    import sys

    from landhydrology_tpu_torch.diagnostics import energy_total, water_mass
    from landhydrology_tpu_torch.runtime import ForcingReader, run_forced, write_forcing

    nz, ncol, days, window = 8, 64, 0.02, 8
    env = dict(os.environ, LANDHYDROLOGY_COMPCACHE="", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(cs.HERE, "experiments", "soil", "forced_reanalysis.py"), "--platform",
         "cpu", "--ncol", str(ncol),
         "--nz", str(nz), "--days", str(days), "--window", str(window), "--workdir", str(tmp_path),
         "--engine", "xla"],
        capture_output=True, text=True, env=env, timeout=600, check=True,
    )
    detail = json.loads(out.stdout.strip().splitlines()[-1])["detail"]
    n = detail["steps"]
    times, rows = cs.reanalysis_forcing(n, ncol, cs.FORCED_DT, days=days)
    mine = tmp_path / "port.bin"
    write_forcing(str(mine), times, rows)
    assert (tmp_path / f"forcing_{n}x{ncol}.bin").read_bytes() == mine.read_bytes()

    land, Y0, Ya = cs.build_reanalysis(nz, ncol, torch.float32, "cpu")
    with ForcingReader(str(mine)) as reader:
        Yf, _ = run_forced(land, Y0, Ya, reader, SSPRK33(), dt=cs.FORCED_DT, window=window, engine="fused",
                           steps_per_call=4)
    dz = 2.0 / nz
    mass = lambda Y: float(water_mass(Y, dz)) + float(torch.sum(Y["surface"]["h_s"]))  # noqa: E731
    assert float(torch.mean(Yf["surface"]["h_s"])) == pytest.approx(detail["pond_mean_m"], rel=1e-4)
    assert (mass(Yf) - mass(Y0)) / ncol == pytest.approx(detail["water_gain_m"], rel=1e-3)
    assert float(energy_total(Yf, dz)) == pytest.approx(detail["energy_total"], rel=1e-5)


def test_diurnal_rows_are_the_jax_tests():
    from tests import test_forcing_driver as jt

    got = cs.diurnal_rows(29, jt.NCOL, jt.DT, np.random.default_rng(7))
    want = jt._diurnal_forcing(29, np.random.default_rng(7))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_F_NZ, _F_NCOL, _F_STEPS, _F_SPC, _F_DAYS = 8, 64, 12, 4, 0.02


@functools.lru_cache(maxsize=None)
def _forced_plain_runs(dtype, doctoring):
    """``(start, end, evaporation, rows)`` of the forced path's plain version
    at a small size (the rain band sweeping most of the columns), or of a
    doctored kernel: one that ignores the rows (the model's own atmosphere
    and rain), one that reads row ``step + 1``, one that drops the rain row."""
    land, Y0, _ = cs.build_reanalysis(_F_NZ, _F_NCOL, dtype, "cpu")
    _, rows_np = cs.reanalysis_forcing(_F_STEPS, _F_NCOL, cs.FORCED_DT, days=_F_DAYS)
    rows = {k: torch.as_tensor(v, dtype=dtype) for k, v in rows_np.items()}
    fed = rows
    if doctoring == "row_step_plus_one":
        fed = {k: torch.cat([v[1:], v[-1:]]) for k, v in rows.items()}
    elif doctoring == "no_rain":
        fed = dict(rows, precipitation=torch.zeros_like(rows["precipitation"]))

    def advance(Y, t, chunk):
        if doctoring == "static_atmosphere":
            return ck.fused_column_run_plain(land, SSPRK33(), cs.FORCED_DT, _F_SPC, Y, t), t + _F_SPC * cs.FORCED_DT
        i = int(round(float(t) / cs.FORCED_DT))
        Yn = ck.fused_column_run_plain(land, SSPRK33(), cs.FORCED_DT, _F_SPC, Y, t,
                                       forcing={k: v[i:i + _F_SPC] for k, v in fed.items()})
        return Yn, t + _F_SPC * cs.FORCED_DT

    end, _, evap = cs.launch_by_launch(advance, land, Y0, rows, cs.FORCED_DT, _F_SPC)
    return land, Y0, end, evap, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_forced_checks_accept_the_plain_version(dtype):
    land, Y0, end, evap, rows = _forced_plain_runs(dtype, None)
    seg = cs.forced_plain(ck, land, cs.FORCED_DT, _F_SPC, Y0, 0.0, rows)
    assert cs._max_abs(cs._np(seg), cs._np(end)) == 0.0  # launch by launch == the segment
    shares = cs.check_forced(cs._np(end), cs._np(end), cs._np(Y0), dtype, "plain")
    assert set(shares) == {"vartheta_l", "rho_e_int", "h_s"}
    change, rain_max, evap_mean, residual = cs.check_budget(land, Y0, end, rows, cs.FORCED_DT, evap, "plain")
    assert rain_max > 1e-3 and residual < 0.1 * cs.BUDGET_SHARE * rain_max and evap_mean > 0


@pytest.mark.parametrize("doctoring", ["static_atmosphere", "row_step_plus_one", "no_rain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_forced_checks_fail_doctored_kernels(dtype, doctoring):
    """Phase 11's state check (against the plain version on the same rows)
    fails a kernel that ignores the rows, reads the next row or drops the
    rain; the water budget fails the ones that lose the rain."""
    land, Y0, plain, evap, rows = _forced_plain_runs(dtype, None)
    _, _, kern, _, _ = _forced_plain_runs(dtype, doctoring)
    with pytest.raises(AssertionError):
        cs.check_forced(cs._np(kern), cs._np(plain), cs._np(Y0), dtype, doctoring)
    if doctoring != "row_step_plus_one":
        with pytest.raises(AssertionError, match="water budget"):
            cs.check_budget(land, Y0, kern, rows, cs.FORCED_DT, evap, doctoring)


def test_forced_bound_counts_the_rows():
    """The forced path's bound reads each streamed row once beside the
    state's bytes."""
    costs = {torch.float32: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    land = ck.MODE_LAND | ck.MODE_MOST
    ms, by = cs.bound_ms(ck, costs, land, torch.float32, NZ * NCOL, 0, ncol=NCOL, probes=17.0,
                         read_values=4 * 24 * NCOL)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (2 * (3 * NZ + 1) * NCOL + 4 * 24 * NCOL) * 4 / cs.HBM_BYTES_PER_S)


# ---- phase 12: the regional-grid path (kernel modes B1-batched and B8) ----


class _Captured(Exception):
    pass


def _regional_script_model(monkeypatch, ncol):
    """``experiments/soil/regional_grid.py``'s model and initial state at
    ``ncol`` columns: its ``main`` run up to the kernel's factory, which
    records the model and stops the run."""
    import importlib.util
    import sys

    import landhydrology_tpu
    import landhydrology_tpu.ops.pallas as pallas

    seen = {}
    init = landhydrology_tpu.initialize_states

    def initialize_states(model, ic, t0):
        seen["Y"], seen["Ya"] = init(model, ic, t0)
        return seen["Y"], seen["Ya"]

    def factory(model, *args, **kwargs):
        seen["model"] = model
        raise _Captured

    monkeypatch.setattr(landhydrology_tpu, "initialize_states", initialize_states)
    monkeypatch.setattr(pallas, "make_fused_column_run", factory)
    monkeypatch.setattr(sys, "argv", ["regional_grid.py", "--ncol", str(ncol)])
    spec = importlib.util.spec_from_file_location(
        "regional_grid", f"{cs.HERE}/experiments/soil/regional_grid.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with pytest.raises(_Captured):
        module.main()
    return seen["model"], seen["Y"]


def test_regional_builder_matches_the_experiment(monkeypatch):
    """``build_regional`` at ncol=256 is ``regional_grid.py``'s float32 model
    and initial state, leaf by leaf, bit for bit: the per-column soils, both
    faces' kinds and values, the grid and the three state fields."""
    from landhydrology_tpu_torch.convert import model_from_reference

    jm, jY = _regional_script_model(monkeypatch, 256)
    model, Y, _, kinds_top = cs.build_regional(48, 256, torch.float32, "cpu")
    ref = model_from_reference(jm, device="cpu", dtype=torch.float32)

    def leaves(obj, path=""):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
        elif not callable(obj) and not isinstance(obj, (str, torch.dtype)):
            yield path, obj

    got = dict(leaves(dataclasses.replace(model, device="cpu")))
    want = dict(leaves(dataclasses.replace(ref, device="cpu")))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert torch.is_tensor(got[k]) and got[k].dtype == v.dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert got[".boundary_conditions.top.hydrology.kind"].dtype == torch.int32
    assert torch.equal(kinds_top, got[".boundary_conditions.top.hydrology.kind"])
    for k, v in cs._np(Y).items():
        np.testing.assert_array_equal(v, np.asarray(jY["soil"][k], dtype=np.float64), err_msg=k)


def test_regional_variable_depth_twin_and_column_slice():
    """The variable-depth twin keeps every draw of the regional model and
    varies the depth alone; ``column_slice`` cuts a sub-model whose plain
    run equals the same columns of the whole batch's."""
    from landhydrology_tpu_torch.domains import VariableDepthColumn

    model, Y, _, _ = cs.build_regional(8, 64, torch.float64, "cpu")
    twin, Yt, _, _ = cs.build_regional(8, 64, torch.float64, "cpu", variable_depth=True)
    assert isinstance(twin.domain, VariableDepthColumn)
    assert 0.8 <= float(twin.domain.height.min()) and float(twin.domain.height.max()) <= 3.0
    assert torch.equal(twin.soil_param_set.nu, model.soil_param_set.nu)
    assert all(torch.equal(Yt["soil"][k], Y["soil"][k]) for k in Y["soil"])
    idx = torch.arange(0, 64, 8)
    for m, Y0 in ((model, Y), (twin, Yt)):
        sub, Ys = cs.column_slice(m, Y0, idx)
        assert sub.domain.batch_shape == (8,) and Ys["soil"]["vartheta_l"].shape == (8, 8)
        whole = cs._np(ck.fused_column_run_plain(m, SSPRK33(), 5.0, 3, Y0, 0.0))
        part = cs._np(ck.fused_column_run_plain(sub, SSPRK33(), 5.0, 3, Ys, 0.0))
        for k in part:
            np.testing.assert_array_equal(part[k], whole[k][:, idx.numpy()], err_msg=k)


def test_grid_variants_cover_every_opened_mode():
    """Phase 12's variants hold every fixed-stage SSPRK33 and implicit
    ``MODE_COLUMNS`` instance of ``column_kernel.cu``, ``implicit_kernel.cu``
    and ``land_kernel.cu``, and B1's, the column-tile kernel's, against its
    plain version (the stage-table and policy instances are phase 19's and
    20's), and the cross-component cases ride on B1."""
    modes = {c for c in cs.GRID_VARIANTS if not c.startswith("cross")}
    sources = {"column_kernel": {"B2", "B3-rate", "B1-water"}, "tile_columns_kernel": {"B1"},
               "implicit_kernel": {"B4-be-richards", "B4-be-richards-water", "B4-trbdf2", "B4-trbdf2-water"},
               "land_kernel": {"B5", "B6"}}
    assert modes == set().union(*sources.values())
    for case in modes:
        model, _, stepper, dt, n = cs.build_grid_variant(8, torch.float64, "cpu", 7, case)
        run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n)
        assert case in sources[ck._entry(run.mode, torch.float64)[0]]
    assert {"cross-energy", "cross-water"} <= set(cs.GRID_VARIANTS)


@pytest.mark.parametrize("case", cs.GRID_VARIANTS)
def test_grid_variant_builds_its_mode(case):
    """Each variant builds the mode it names with the per-column features
    that mode takes, and its plain launch moves the state and stays finite."""
    model, Y, stepper, dt, n = cs.build_grid_variant(32, torch.float64, "cpu", 7, case)
    mode = "B1" if case.startswith("cross") else case
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n)
    assert run.name == mode + "+kinds+B8" == ck.mode_name(run.mode, ck.per_column_features(model))
    start = cs._np(Y)
    end = cs._np(ck.fused_column_run_plain(model, stepper, dt, n, Y, 2.0))
    assert all(np.isfinite(v).all() for v in end.values())
    assert np.max(np.abs(end["vartheta_l"] - start["vartheta_l"])) > 1e-6
    if case.startswith("cross"):
        top = model.boundary_conditions.top
        plain, batched = (top.energy, top.hydrology) if case == "cross-energy" else (top.hydrology, top.energy)
        assert type(plain).__name__ == "Dirichlet" and type(batched).__name__ == "BatchedBC"
        assert bool((batched.kind == 1).any()) and bool((batched.kind == 0).any())


def test_per_column_values_count_the_grid_and_the_kinds():
    """The bound reads a per-column grid once (centers and spacing) and the
    kind columns as int32."""
    model, _, _, _ = cs.build_regional(8, 64, torch.float64, "cpu")
    twin, _, _, _ = cs.build_regional(8, 64, torch.float32, "cpu", variable_depth=True)
    run = ck.make_fused_column_run(model, dt=5.0, steps_per_call=2)
    assert cs.per_column_values(run, 8, 64, torch.float64) == 2 * 64 // 2
    run = ck.make_fused_column_run(twin, dt=5.0, steps_per_call=2)
    assert cs.per_column_values(run, 8, 64, torch.float32) == 8 * 64 + 64 + 2 * 64


def test_check_diverged_holds_the_columns_that_leave_the_finite_numbers():
    """A column past its explicit limit leaves the range (non-finite, or
    vartheta_l outside [0, 1]) in the kernel and in the plain version alike:
    the check accepts that, holds the other columns to the bars, and fails
    a kernel that diverges alone or that is off on a sound column."""
    rng = np.random.default_rng(0)
    start = {"vartheta_l": rng.uniform(0.2, 0.3, (8, 6)), "rho_e_int": rng.uniform(1e7, 2e7, (8, 6))}
    plain = {k: v * (1.0 + 1e-3 * rng.random(v.shape)) for k, v in start.items()}
    plain["vartheta_l"][:, 4] = np.nan
    plain["rho_e_int"][3, 4] = np.inf
    kern = {k: v.copy() for k, v in plain.items()}
    shares, err, diverged = cs.check_diverged(kern, plain, start, torch.float64, "same", MOVING)
    assert diverged == 1 and err == 0.0 and set(shares) == set(MOVING)
    alone = {k: v.copy() for k, v in kern.items()}
    alone["vartheta_l"][0, 1] = np.nan
    with pytest.raises(AssertionError, match="diverges in columns"):
        cs.check_diverged(alone, plain, start, torch.float64, "alone", MOVING)
    wild = {k: v.copy() for k, v in kern.items()}  # finite, but out of the range in both
    wild["vartheta_l"][:, 2] = 1.5
    plain_wild = {k: v.copy() for k, v in plain.items()}
    plain_wild["vartheta_l"][:, 2] = -0.5
    assert cs.check_diverged(wild, plain_wild, start, torch.float64, "wild", MOVING)[2] == 2
    off = {k: v.copy() for k, v in kern.items()}
    off["rho_e_int"][2, 0] *= 1.0 + 1e-9
    with pytest.raises(AssertionError):
        cs.check_diverged(off, plain, start, torch.float64, "off", MOVING)
    a = torch.tensor([1.0, float("nan"), 3.0])
    assert cs._equal_nan(a, a.clone()) and not cs._equal_nan(a, torch.tensor([1.0, 2.0, 3.0]))


# ---- phase 13: adaptive stepping (kernel modes B1-dt and B4+B5) ----


@pytest.fixture
def plain_card(monkeypatch):
    """Phase 13's functions on the CPU: the fused run's plain version stands
    in for the kernel and counts its launches as the kernel does; no
    synchronization, and CUDA-event times of 1 ms."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_time_ms", lambda fn, reps: (fn(), 1.0)[1])

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            pass

        def elapsed_time(self, other):
            return 1.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    call = ck.FusedColumnRun.__call__

    def counted(self, Y, t0, forcing=None, dt_run=None):
        out = call(self, Y, t0, forcing=forcing, dt_run=dt_run)
        ck.LAUNCHES[self.name] += 1
        return out

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", counted)
    return call


def test_b4_b5_bound_counts_a_most_solve_per_rhs_evaluation():
    """Under a MOST top the implicit steppers solve MOST once per rhs
    evaluation: 1 + 4 iters per TR-BDF2 step, 2 iters for BackwardEulerSoil,
    iters + 1 for BackwardEulerRichards; the bound grows with them."""
    most = ck.MODE_MOST
    assert [cs.most_exchanges(ck, most | m, 2) for m in (ck.MODE_TRBDF2, ck.MODE_BE_SOIL, ck.MODE_BE_RICHARDS)] \
        == [9, 4, 3]
    assert cs.most_exchanges(ck, most | ck.MODE_TRBDF2, 3) == 13
    assert (cs.most_exchanges(ck, most), cs.most_exchanges(ck, ck.MODE_LAND | ck.MODE_SURFACE_STEP)) == (3, 1)
    per = cs.column_step_ops(ck, most | ck.MODE_TRBDF2, torch.float64, probes=96.0)
    ssp = cs.column_step_ops(ck, most, torch.float64, probes=96.0)
    assert per["log"] == 3 * ssp["log"] and per["sqrt"] == 3 * ssp["sqrt"]
    costs = {torch.float64: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    b_tr, _ = cs.bound_ms(ck, costs, most | ck.MODE_TRBDF2, torch.float64, 24 * 1024, 4, ncol=1024, probes=96.0)
    b_plain, _ = cs.bound_ms(ck, costs, ck.MODE_TRBDF2, torch.float64, 24 * 1024, 4)
    assert b_tr > b_plain


def test_dt_run_cases_cover_every_mode_of_the_kernel_table(monkeypatch):
    """Phase 13b launches every mode the kernels run at dt_run: the SSPRK33,
    implicit, land and forced modes, the kinds and geometry instances and
    the B4+B5 instances with and without rows."""
    monkeypatch.setattr(cs, "DT_RUN_NCOL", 8)
    names = {ck.make_fused_column_run(m, st, forcing_fields=tuple(rows or ()), forcing_time_grid=grid,
                                      steps_per_call=n).name
             for m, _, st, _, n, _, rows, grid, _ in cs.dt_run_cases(torch.float64, "cpu")}
    expected = {"B1", "B1-no-ice", "B2", "B2-no-ice", "B3-rate", "B3-eq", "B2+B3-rate", "B2+B3-eq", "B1-water",
                "B1-heat", "B4-trbdf2", "B4-trbdf2-pcr", "B4-trbdf2-water", "B4-trbdf2-heat", "B4-be-soil",
                "B4-be-richards", "B4-be-richards-water", "B5", "B2+B5", "B6", "B6-step", "B2+B6", "B2+B6-step",
                "B6-pond", "B6-step-pond", "B2+B6-pond", "B2+B6-step-pond", "B5+B7", "B2+B5+B7-time", "B6+B7",
                "B6-step+B7-time", "B2+B6-step-pond+B7-time", "B1+kinds+B8", "B2+kinds+B8", "B3-rate+kinds+B8",
                "B1-water+kinds+B8", "B4-be-richards+kinds+B8", "B4-be-richards-water+kinds+B8",
                "B4-trbdf2+kinds+B8", "B4-trbdf2-water+kinds+B8", "B5+kinds+B8", "B6+kinds+B8", "B4-trbdf2+B5",
                "B4-trbdf2-pcr+B5", "B4-be-soil+B5", "B4-be-richards+B5", "B4-trbdf2+B5+B7",
                "B4-trbdf2+B5+B7-time", "B4-be-soil+B5+B7-time", "B4-be-richards+B5+B7"}
    assert names == expected


def test_dt_run_check_fails_a_launch_that_ignores_dt_run(plain_card, monkeypatch):
    """Phase 13b's check passes the plain version standing in for the kernel
    and fails a kernel that launches at the factory dt instead of dt_run."""
    monkeypatch.setattr(cs, "DT_RUN_NCOL", 8)
    cases = cs.dt_run_cases(torch.float64, "cpu")
    for case in (cases[0], cases[-3]):  # B1 (callable BC values) and B4-trbdf2+B5+B7-time
        name, err, _ = cs.check_dt_run(ck, *case)
        assert err == 0.0
    call = ck.FusedColumnRun.__call__

    def factory_dt(self, Y, t0, forcing=None, dt_run=None):
        return call(self, Y, t0, forcing=forcing)

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", factory_dt)
    for case in (cases[0], cases[-3]):
        with pytest.raises(AssertionError, match="differs from a run built"):
            cs.check_dt_run(ck, *case)


def test_adaptive_golden_check_fails_a_driver_that_mutates_the_state(plain_card, monkeypatch):
    """Phase 13a's check of golden case a passes the port's fused driver
    and fails one whose segments step the state in place, so that a
    rejected iteration leaves it changed."""
    from landhydrology_tpu_torch import adaptive

    gc = cs._load_golden_config()
    golden = np.load("tests/data/golden_adaptive_f64.npz")
    model, Y, Ya, st, kw = gc.build_adaptive_case("a", torch.float64, "cpu")
    log = []
    Yf, stats = adaptive.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=log, **kw)
    gc.check_adaptive_run(golden, "a", stats, cs._np(Yf), log)
    monkeypatch.setattr(adaptive, "_clone", lambda Y: Y)
    model, Y, Ya, st, kw = gc.build_adaptive_case("a", torch.float64, "cpu")
    log = []
    Yf, stats = adaptive.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=log, **kw)
    with pytest.raises(AssertionError):
        gc.check_adaptive_run(golden, "a", stats, cs._np(Yf), log)


def test_adaptive_path_checks_the_first_iteration_and_the_fine_run(plain_card, monkeypatch):
    """Phase 13c's driver of one full-width run, at nz=8 x 64 with the
    plain version as the kernel: three launches per iteration counted, the
    first iteration's launches against the plain version on the strided
    columns, the final state within the accepted tolerance of the fixed-dt
    run; a kernel that ignores dt_run fails the first-iteration check."""
    from landhydrology_tpu_torch.adaptive import AdaptiveConfig
    from landhydrology_tpu_torch.timestepping import SSPRK33 as PortSSPRK33

    monkeypatch.setattr(cs, "ADAPTIVE_SAMPLE", 4)  # every 16th of the 64 columns
    model, Y0, Ya = cs.build_bench_model(8, 64, torch.float64, "cpu")
    config = AdaptiveConfig()
    final, log, run, launches, err, _ = cs.adaptive_path(ck, "smi", "adaptive bench", model, Y0, Ya,
                                                         PortSSPRK33(), 8, 600.0, 1.0, config,
                                                         ("vartheta_l", "rho_e_int"))
    assert launches == 3 * len(log) and err == 0.0 and run.name == "B1"
    cs.fine_check(ck, "adaptive bench", model, Y0, PortSSPRK33(), 8, 600.0, log, final, config)
    call = ck.FusedColumnRun.__call__
    monkeypatch.setattr(ck.FusedColumnRun, "__call__",
                        lambda self, Y, t0, forcing=None, dt_run=None: call(self, Y, t0, forcing=forcing))
    with pytest.raises(AssertionError):
        cs.adaptive_path(ck, "smi", "adaptive bench", model, Y0, Ya, PortSSPRK33(), 8, 600.0, 1.0, config,
                         ("vartheta_l", "rho_e_int"))


def test_implicit_bound_counts_the_step_policies():
    """The B4 + policy bounds: lagged coefficients add one coefficient pass
    per step and the heat sweeps' live kappa, and drop the closures of the
    rhs that are not water sweeps; rate freeze-thaw adds the sources of
    every rhs evaluation and of theta_i's fixed points (2 pow each);
    the equilibrium projection adds its bisection once per step."""
    iters = 2
    for stepper, evaluations, fixed in ((ck.MODE_TRBDF2, 1 + 4 * iters, 2 * iters),
                                        (ck.MODE_BE_SOIL, 2 * iters, 1), (ck.MODE_BE_RICHARDS, iters + 1, 0)):
        base = cs.cell_step_ops(ck, stepper)
        rate = cs.cell_step_ops(ck, stepper | ck.MODE_FREEZE_RATE)
        assert rate["pow"] - base["pow"] == 2 * (evaluations + fixed)
        eq = cs.cell_step_ops(ck, stepper | ck.MODE_FREEZE_EQ, n_iter=60)
        assert eq["pow"] - base["pow"] == 2 * 60 + 4
        lagged = cs.cell_step_ops(ck, stepper | ck.MODE_LAGGED)
        heat_sweeps = {ck.MODE_TRBDF2: 2 * iters, ck.MODE_BE_SOIL: iters, ck.MODE_BE_RICHARDS: 0}[stepper]
        water_sweeps = 2 * iters if stepper == ck.MODE_TRBDF2 else iters
        coupled_rhs = evaluations - water_sweeps
        closures_exp = 5
        assert lagged["exp"] - base["exp"] == (closures_exp + cs._THERMAL["exp"] * heat_sweeps
                                               - closures_exp * coupled_rhs)
    no_ice = cs.cell_step_ops(ck, ck.MODE_TRBDF2 | ck.MODE_NO_ICE)
    assert no_ice["exp"] < cs.cell_step_ops(ck, ck.MODE_TRBDF2)["exp"]


def test_b9_modes_cover_every_plain_soil_mode(monkeypatch):
    """Phase 14b launches every plain-soil mode of the kernel table as a B9
    forward: the SSPRK33 modes, each implicit stepper alone and with each
    step policy (TR-BDF2 with PCR too), the water-only and heat-only
    branches, the per-column kinds and depths, and a MOST top under
    SSPRK33, lagged and TR-BDF2 (B5, B2+B5, B4-trbdf2+B5); its policy paths time
    each new instance beside its stepper without a policy."""
    monkeypatch.setattr(cs, "GRAD_NCOL", 8)
    gc = cs._load_golden_config()
    names = [ck.make_fused_column_run(m, st, differentiable=True).name
             for m, _, st, _ in cs.b9_modes(gc, torch.float64, "cpu")]
    policies = ("", "+B2", "+B3-rate", "+B3-eq", "-no-ice", "+B2+B3-rate", "+B2+B3-eq")
    expected = {"B1", "B1-no-ice", "B2", "B2-no-ice", "B3-rate", "B3-eq", "B2+B3-rate", "B2+B3-eq",
                "B1-water", "B1-heat", "B4-trbdf2-water", "B4-trbdf2-heat", "B4-be-richards-water",
                "B4-trbdf2-pcr", "B4-trbdf2-pcr+B2+B3-eq", "B1+kinds+B8", "B4-trbdf2+kinds+B8",
                "B5", "B2+B5", "B4-trbdf2+B5"}
    expected |= {f"B4-{s}{p}" for s in ("trbdf2", "be-soil", "be-richards") for p in policies}
    assert len(names) == len(set(names)) and set(names) == {f"B9:{n}" for n in expected}


def test_b9_forward_check_passes_the_plain_version_and_fails_a_zero_gradient(plain_card, monkeypatch):
    """``b9_forward`` on the CPU (the plain version standing in for the
    kernel): it passes, and it fails a backward that returns zeros for the
    state."""
    from landhydrology_tpu_torch.ops.cuda import differentiable

    gc = cs._load_golden_config()
    model, Y, _, _ = gc.build_model_and_state(torch.float64, "cpu")
    name, dev = cs.b9_forward(ck, gc, model, Y, SSPRK33(), 10.0, 2)
    assert name == "B9:B1" and dev <= 1e-12
    real = differentiable.DifferentiableFusedRun.vjp

    def zeros(self, fields, t0, dt, grads, need_t0=True, need_dt=True):
        g_t0, g_dt, g = real(self, fields, t0, dt, grads, need_t0, need_dt)
        return g_t0, g_dt, [torch.zeros_like(x) for x in g]

    monkeypatch.setattr(differentiable.DifferentiableFusedRun, "vjp", zeros)
    with pytest.raises(AssertionError, match="deviates"):
        cs.b9_forward(ck, gc, model, Y, SSPRK33(), 10.0, 2)


def test_time_policy_checks_and_times_a_policy_path(plain_card):
    """``time_policy`` (14b) on the CPU, the plain version standing in for
    the kernel: one launch counted, the check passes against the timed
    plain run's state, and the record has every key of the kernels line
    with two plain samples averaged; a kernel that leaves the state as it
    was fails the check."""
    gc = cs._load_golden_config()
    model, Y, _, _ = gc.build_freeze_model_and_state(torch.float64, "cpu")
    model = cs._policy(dataclasses.replace(model, freeze_thaw=None), cs.B4_POLICIES[4])
    st = cs.implicit("TRBDF2Soil", model, 2)
    costs = {torch.float64: {"exp": 10, "log": 10, "sqrt": 2, "div": 5, "pow": 20}}
    entry, err, shares = cs.time_policy(ck, costs, "smi", model, Y, st, "policy")
    assert entry["name"].endswith("B4-trbdf2+B2+B3-rate>") and entry["launches"] == 1
    assert entry["ms"] == 1.0 and entry["plain_ms"] == 1.0 and err == 0.0 and set(shares) == {"vartheta_l",
                                                                                               "rho_e_int"}
    assert set(entry) == {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                          "bound_ms", "bound_by", "library_ms"}

    def idle(self, Y, t0, forcing=None, dt_run=None):
        ck.LAUNCHES[self.name] += 1
        return Y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck.FusedColumnRun, "__call__", idle)
        with pytest.raises(AssertionError):
            cs.time_policy(ck, costs, "smi", model, Y, st, "policy")


def test_grad_small_passes_on_the_plain_version(plain_card, capsys):
    """14a on the CPU, the plain version standing in for the kernel: the
    gradient golden, the MOST soils against the JAX package's forward
    differenced, and the JAX fused test's column all pass, one launch
    counted each."""
    cs.grad_small(ck, cs._load_golden_config(), "cpu")
    out = capsys.readouterr().out
    assert out.count("[14a grad golden]") == len(cs._load_golden_config().GRAD_CASES) + 3 + 1
    assert "B9:B4-trbdf2+B5 most_trbdf2" in out
