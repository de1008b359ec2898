"""The port's adaptive drivers (``landhydrology_tpu_torch/adaptive.py``)
against the JAX package, f64 on the CPU (the fused engine through the
kernels' plain version): the analogues of every test of
``tests/test_adaptive.py`` and of ``tests/soil/test_imex.py:446``.

The JAX package's runs are frozen in ``tests/data/golden_adaptive_f64.npz``
(``tests/data/make_golden_adaptive.py``), so these tests run the port only.
Each holds the JAX test's own bars on the port's run; the port's free run
against JAX's (equal counts, ``dt_final`` within ``DT_FINAL_RTOL``, the
state within ``FREE_STATE_BAR`` of each field's largest value); and the
port replaying JAX's iteration records (the same steps and decisions):
error norms within the noise bar of ``golden_config_torch.check_replay_errors``
and the final state at rtol 1e-10 (TR-BDF2: 1e-9).

Why not 1e-12 on dt: the error norm divides the difference of two solutions
that agree to about ``rtol`` by ``rtol`` times the state, so a last-bit
difference in a step moves the norm by ``eps / rtol`` and the PI controller
carries that into every later dt.  The port and XLA round differently in a
few closures, so their dt agree to about ``1e-7`` in mid-run and ``1e-5``
after a short last step; JAX's own reruns from one-ulp moves of the initial
state spread as far (``*_ulp_*`` of the golden).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import adaptive as jax_adaptive
from landhydrology_tpu_torch import adaptive as pa
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy, stepper_from_reference
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.land import LandModel, make_rhs as make_land_rhs
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config_torch as gct
from tests.data import make_golden_adaptive as mg

F64 = torch.float64
GOLDEN = np.load("tests/data/golden_adaptive_f64.npz")
#: a free run's dt_final against JAX's: the rounding of the last step's error norm
DT_FINAL_RTOL = 1e-5
#: a free run's state against JAX's, relative to each field's largest value:
#: two runs whose dt differ by their error norms' rounding end this close
FREE_STATE_BAR = 1e-7


def _np_state(Y):
    return {k: _np_state(v) for k, v in Y.items()} if isinstance(Y, dict) else np.asarray(Y)


def port_case(name):
    """The port's model, state, rhs and stepper of the JAX test ``name``
    (``make_golden_adaptive.CASES``), converted from the JAX package's."""
    spec = mg.CASES[name]()
    model = model_from_reference(spec["model"], device="cpu")
    soil = model.soil if isinstance(model, LandModel) else model
    out = dict(spec, model=model, Y=state_from_numpy(_np_state(spec["Y"]), device="cpu"),
               Ya=state_from_numpy(_np_state(spec["Ya"]), device="cpu"))
    grid = make_function_space(soil.domain, F64, "cpu")
    out["rhs"] = make_land_rhs(model, grid) if isinstance(model, LandModel) else make_rhs(model, grid)
    if not isinstance(spec["stepper"], mg.SSPRK33):
        out["stepper"] = stepper_from_reference(spec["stepper"], soil)
    else:
        out["stepper"] = SSPRK33()
    out["config"] = pa.AdaptiveConfig(**dataclasses.asdict(spec["config"]))
    return out


def run_port(case, engine="torch", replay=None):
    """The port's driver of ``case`` (``port_case``): ``engine`` "torch"
    (``run_adaptive``, ``run_adaptive_forced(engine="torch")``) or "fused"
    (``run_adaptive_fused``, ``run_adaptive_forced(engine="fused")``), the
    JAX test's steps per segment.  Returns ``(Y, stats, log)``."""
    log = []
    args = (case["Y"], case["Ya"], 0.0, case["tf"], case["dt0"])
    kw = dict(stepper=case["stepper"], config=case["config"], log=log, replay=replay)
    if "forcing" in case:
        Y, stats = pa.run_adaptive_forced(case["model"], *args, forcing=case["forcing"],
                                          forcing_dt=case["forcing_dt"], engine=engine,
                                          steps_per_call=case.get("steps_per_call", 1), **kw)
    elif engine == "fused":
        Y, stats = pa.run_adaptive_fused(case["model"], *args, steps_per_call=case.get("steps_per_call", 1), **kw)
    else:
        Y, stats = pa.run_adaptive(case["rhs"], *args, model=case["model"] if case.get("policies") else None, **kw)
    return Y, stats, log


def hold_free(name, stats, Y, equal_counts=True):
    """A free port run against JAX's run of ``name``."""
    if equal_counts:
        assert (int(stats["n_accepted"]), int(stats["n_rejected"])) == (
            int(GOLDEN[f"{name}__n_accepted"]), int(GOLDEN[f"{name}__n_rejected"]))
        np.testing.assert_allclose(float(stats["dt_final"]), float(GOLDEN[f"{name}__dt_final"]),
                                   rtol=DT_FINAL_RTOL)
    got = state_to_numpy(Y)
    for group, fields in gct.golden_state(GOLDEN, name).items():
        for k, v in fields.items():
            dev = float(np.max(np.abs(got[group][k] - v))) / (float(np.max(np.abs(v))) or 1.0)
            assert dev <= FREE_STATE_BAR, (name, group, k, dev)


def hold_replay(name, case, log, Y, rtol=1e-10, err_rel=0.0):
    """The port replaying JAX's records of ``name``: error norms (``err_rel``:
    see ``check_replay_errors``), decisions and the final state of JAX's
    iteration loop at ``rtol``."""
    ratio = gct.check_replay_errors(gct.golden_records(GOLDEN, name), log, case["config"].rtol, name, rel=err_rel)
    got = state_to_numpy(Y)
    for group, fields in gct.golden_state(GOLDEN, name, "replay").items():
        for k, v in fields.items():
            np.testing.assert_allclose(got[group][k], v, rtol=rtol, atol=1e-16, err_msg=f"{name}/{group}/{k}")
    return ratio


def _fixed(case, stepper, dt, n):
    """``n`` eager steps of ``dt`` of the port's rhs (the JAX tests' fixed-dt reference)."""
    Y, t = case["Y"], torch.tensor(0.0, dtype=F64)
    for _ in range(n):
        Y = stepper.step(case["rhs"], Y, case["Ya"], t, torch.tensor(dt, dtype=F64))
        t = t + dt
    return Y


def test_config_defaults_and_exponents_match_jax():
    assert dataclasses.asdict(pa.AdaptiveConfig()) == dataclasses.asdict(jax_adaptive.AdaptiveConfig())
    cfg = pa._with_exponents(pa.AdaptiveConfig(), SSPRK33())
    assert (cfg.k_p, cfg.k_i) == (0.7 / 4.0, 0.4 / 4.0)
    case = port_case("trbdf2_order")
    cfg = pa._with_exponents(pa.AdaptiveConfig(k_i=0.1), case["stepper"])
    assert case["stepper"].order == 2 and (cfg.k_p, cfg.k_i) == (0.7 / 3.0, 0.1)


def test_adaptive_matches_fixed_fine_dt():
    """``test_adaptive.py:43``: sand infiltration to 120 s, rtol 1e-6."""
    case = port_case("infiltration")
    Y, stats, _ = run_port(case)
    ref = _fixed(case, SSPRK33(), 0.05, 2400)
    v, v_ref = state_to_numpy(Y)["soil"]["vartheta_l"], state_to_numpy(ref)["soil"]["vartheta_l"]
    assert np.all(np.isfinite(v)) and np.max(np.abs(v - v_ref)) < 5e-4
    n_acc, n_rej = int(stats["n_accepted"]), int(stats["n_rejected"])
    assert n_acc < 2400 and float(stats["dt_final"]) > 0.01 and n_rej < n_acc and bool(stats["converged"])
    hold_free("infiltration", stats, Y)
    Yr, _, log = run_port(case, replay=gct.golden_records(GOLDEN, "infiltration"))
    hold_replay("infiltration", case, log, Yr)


def test_adaptive_handles_stiffness_without_blowup():
    """``test_adaptive.py:83``: the saturated column from 40x its explicit
    limit.  The controller rejects 28 of JAX's 184 iterations at the stiff
    scale, where rounding decides, so the free run holds JAX's bars and its
    state within the drift bar of JAX's, and the replay holds the rest.
    SSPRK33 steps at its stability limit here, which amplifies rounding
    within each step: the replay's error norms agree with JAX's to 1.5e-4
    of the norm (CPU, f64), held at 1e-3; the decisions and the final state
    (6.6e-12) to the usual bars."""
    case = port_case("stiff")
    Y, stats, _ = run_port(case)
    v, v0 = state_to_numpy(Y)["soil"]["vartheta_l"], state_to_numpy(case["Y"])["soil"]["vartheta_l"]
    assert np.all(np.isfinite(v)) and np.max(np.abs(v - v0)) < 1e-5
    assert float(stats["dt_final"]) < 1.0 and bool(stats["converged"])
    ref = gct.golden_state(GOLDEN, "stiff")["soil"]["vartheta_l"]
    assert np.max(np.abs(v - ref)) < 1e-5
    Yr, _, log = run_port(case, replay=gct.golden_records(GOLDEN, "stiff"))
    hold_replay("stiff", case, log, Yr, err_rel=1e-3)


def test_adaptive_fused_spc1_reduces_to_run_adaptive():
    """``test_adaptive.py:160``: the fused run at one step per segment is
    ``run_adaptive`` (equal bit for bit in the port), and both match JAX's
    ``run_adaptive``."""
    case = port_case("batched")
    Yx, sx, lx = run_port(case)
    Yf, sf, lf = run_port(case, "fused")
    assert lx == lf and (int(sx["n_accepted"]), int(sx["n_rejected"])) == (int(sf["n_accepted"]), int(sf["n_rejected"]))
    for k, v in state_to_numpy(Yx)["soil"].items():
        np.testing.assert_array_equal(state_to_numpy(Yf)["soil"][k], v)
    hold_free("batched", sf, Yf)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "batched"))
    hold_replay("batched", case, log, Yr)


def test_adaptive_fused_segments_match_fine_reference():
    """``test_adaptive.py:191``: segments of 6 steps, against JAX's fine
    fixed-dt reference and JAX's fused run."""
    case = dict(port_case("segments"), steps_per_call=6)
    Y, stats, _ = run_port(case, "fused")
    v = state_to_numpy(Y)["soil"]["vartheta_l"]
    v_ref = gct.golden_state(GOLDEN, "segments", "fine")["soil"]["vartheta_l"]
    assert bool(stats["converged"]) and np.all(np.isfinite(v)) and np.max(np.abs(v - v_ref)) < 5e-4
    assert float(stats["dt_final"]) > 0.02 and int(stats["n_accepted"]) < 60.0 / 0.05 / 6
    hold_free("segments", stats, Y)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "segments"))
    hold_replay("segments", case, log, Yr)


def test_adaptive_terminates_on_nan_rhs():
    """``test_adaptive.py:219``: a NaN rhs rejects until dt_min, then the
    floor force-accepts; the iteration cap ends the loop, as in JAX."""
    def bad_rhs(Y, Ya, t):
        return {"m": {"x": Y["m"]["x"] * float("nan")}}

    cfg = dict(dt_min=1e-3, max_steps=500)
    _, stats = pa.run_adaptive(bad_rhs, {"m": {"x": torch.ones(4, dtype=F64)}}, {}, 0.0, 10.0, dt0=1.0,
                               config=pa.AdaptiveConfig(**cfg))
    _, ref = jax_adaptive.run_adaptive(lambda Y, Ya, t: {"m": {"x": Y["m"]["x"] * jnp.nan}},
                                       {"m": {"x": jnp.ones(4)}}, {}, 0.0, 10.0, dt0=1.0,
                                       config=jax_adaptive.AdaptiveConfig(**cfg))
    assert int(stats["n_accepted"]) + int(stats["n_rejected"]) <= 500
    for key in ("n_accepted", "n_rejected"):
        assert int(stats[key]) == int(ref[key])
    assert float(stats["dt_final"]) == float(ref["dt_final"]) and bool(stats["converged"]) == bool(ref["converged"])


def test_adaptive_land_model_matches_fixed_fine_dt():
    """``test_adaptive.py:327`` to 30 s (JAX's test runs 120 s): the frozen
    exchange under error control against a fixed dt of 0.5 s, and JAX's run."""
    from landhydrology_tpu_torch import Simulation

    case = port_case("land6")
    Y, stats, _ = run_port(case)
    assert bool(stats["converged"])
    ref = Simulation(case["model"], SSPRK33(), Y_init=case["Y"], Ya_init=case["Ya"], dt=0.5,
                     tspan=(0.0, case["tf"])).run().state(-1)
    got, ref = state_to_numpy(Y), state_to_numpy(ref)
    for group in ("soil", "surface"):
        for k, b in ref[group].items():
            assert np.max(np.abs(got[group][k] - b)) / (np.max(np.abs(b)) + 1e-30) < 5e-4, (group, k)
    hold_free("land6", stats, Y)


def test_adaptive_fused_land_matches_adaptive_xla():
    """``test_adaptive.py:355`` to 30 s: the fused run (the LandModel's
    frozen exchange in the kernel, B6-step) against ``run_adaptive(model=)``
    in the port and JAX's ``run_adaptive``."""
    case = port_case("land7")
    Yf, sf, _ = run_port(case, "fused")
    hold_free("land7", sf, Yf)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "land7"))
    hold_replay("land7", case, log, Yr)


def test_adaptive_uses_trbdf2_order():
    """``tests/soil/test_imex.py:446``: TR-BDF2's order sets the PI
    exponents; the controller keeps dt past twice the explicit limit and
    lands within 1e-5 of JAX's fine fixed-dt TR-BDF2."""
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    case = port_case("trbdf2_order")
    Y, stats, _ = run_port(case)
    v = state_to_numpy(Y)["soil"]["vartheta_l"]
    assert bool(stats["converged"]) and np.all(np.isfinite(v))
    assert float(stats["dt_final"]) > 2.0 * float(explicit_dt_limit(case["model"], case["Y"]))
    np.testing.assert_allclose(v, gct.golden_state(GOLDEN, "trbdf2_order", "fine")["soil"]["vartheta_l"], atol=1e-5)
    hold_free("trbdf2_order", stats, Y)
    Yr, _, log = run_port(case, replay=gct.golden_records(GOLDEN, "trbdf2_order"))
    hold_replay("trbdf2_order", case, log, Yr, rtol=1e-9)


def test_driver_validation():
    case = port_case("batched")
    with pytest.raises(ValueError, match="forcing_dt"):
        pa.run_adaptive_fused(case["model"], case["Y"], case["Ya"], 0.0, 1.0, 0.1, forcing={"u_atm": np.ones(4)})
    with pytest.raises(ValueError, match="unknown engine"):
        pa.run_adaptive_forced(case["model"], case["Y"], case["Ya"], 0.0, 1.0, 0.1, forcing={}, forcing_dt=1.0,
                               engine="xla")
