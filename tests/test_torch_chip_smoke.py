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
