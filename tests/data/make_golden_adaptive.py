"""Generate the adaptive-controller golden (``golden_adaptive_f64.npz``; run
once, output committed) with the JAX package on the CPU in f64.

Two cases freeze the step-doubling PI controller of
``landhydrology_tpu/adaptive.py`` (their parameters are ``ADAPTIVE_A`` and
``ADAPTIVE_B`` of ``golden_config_torch.py``):

- ``a_*``: golden #1's configuration (``golden_config.build_model_and_state``,
  nz=24 x 8) under ``run_adaptive_fused(SSPRK33(), steps_per_call=4,
  tile_cols=8, interpret=True)`` from 0 to 3,600 s, dt0 = 100 s,
  ``AdaptiveConfig(rtol=1e-8, atol=1e-12)`` (the default tolerances reject no
  step on this configuration).  Besides the counts, ``dt_final`` and the final
  state, it keeps the controller's dt and the accepted count after each
  iteration (``a_dt_seq``, ``a_acc_seq``): the API returns only the final
  stats, so iteration k is the run capped at ``AdaptiveConfig(max_steps=k)``.
- ``b_*``: the forced golden's soil and rows
  (``golden_config.build_forced_model_state_and_rows``: 40 rows, scalar
  ``u_atm``, per-column ``theta_atm`` and ``q_atm``) as a time-indexed table
  with dt_forcing = 60 s, under ``run_adaptive_forced(engine="xla",
  stepper=TRBDF2Soil(iters=2))`` from 0 to 2,400 s, dt0 = 120 s,
  ``AdaptiveConfig(rtol=1e-6, atol=1e-10)``: the counts, ``dt_final``, the
  final state, the iteration records (``b_seq_*``, below) and the state
  after ``b_k`` iterations (``b_k_*``).

The error norm subtracts two solutions that agree to about ``rtol``, so each
run's dt carries rounding noise that the PI controller feeds forward.  To
measure how far that moves the reference itself, both cases are rerun with
one field of the initial state moved by one unit in the last place
(``*_ulp_*``: counts, ``dt_final`` and the largest deviation of the final
state relative to each field's largest value; case a: vartheta_l up, down,
rho_e_int up; case b: vartheta_l up, rho_e_int up).

The JAX package's own adaptive tests (``tests/test_adaptive.py``, the
adaptive tests of ``tests/test_forcing_driver.py`` and
``tests/soil/test_imex.py:446``) are frozen too, one entry of ``CASES``
each, keys ``<case>__*``: counts, ``dt_final``, the final state
(``<case>__<group>__<field>``) and, where their test compares with a fixed
step, that reference (``<case>__fine__<group>__<field>``).  The port's tests
compare with these instead of running JAX for minutes.

Iteration records (``<case>__seq_t``, ``_dt``, ``_err``, ``_accept``, and
``b_seq_*``): each iteration's start time, step, error norm and decision.
The drivers return only their final stats, so the records come from a
Python loop over the driver's step-doubling body, compiled once, with
``run_adaptive``'s controller arithmetic.  XLA compiles that body apart
from the driver's ``while_loop``, which can round differently, so the loop
is a run of its own: its final state is ``<case>__replay__<group>__<field>``
(case b: the script checks that its loop ends on the driver's counts,
``dt_final`` and state, bit for bit).  A port replays the records: it takes
the same steps and its error norms and final state must match the loop's.

Usage: python tests/data/make_golden_adaptive.py   (about 20 minutes)
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from landhydrology_tpu.adaptive import AdaptiveConfig, run_adaptive, run_adaptive_forced, run_adaptive_fused
from landhydrology_tpu.domains import make_function_space
from landhydrology_tpu.imex import TRBDF2Soil
from landhydrology_tpu.timestepping import SSPRK33
from tests.data.golden_config import build_forced_model_state_and_rows, build_model_and_state
from tests.data.golden_config_torch import ADAPTIVE_A as A, ADAPTIVE_B as B

#: the perturbed runs: (field, direction) of the one-ulp move of the initial state
A_ULP = (("vartheta_l", 1), ("vartheta_l", -1), ("rho_e_int", 1))
B_ULP = (("vartheta_l", 1), ("rho_e_int", 1))
#: iterations of case b after which the golden keeps the state
B_K = 40


def _bump(Y, ulp):
    if ulp is None:
        return Y
    k, sign = ulp
    v = np.asarray(Y["soil"][k])
    return {"soil": dict(Y["soil"], **{k: jnp.asarray(np.nextafter(v, sign * np.inf))})}


def _deviation(Yf, ref):
    """The largest deviation of each field relative to its largest value."""
    return max(float(np.max(np.abs(np.asarray(v) - ref[k])) / (np.max(np.abs(ref[k])) or 1.0))
               for k, v in Yf["soil"].items())


# ---- the JAX package's adaptive tests, as driver specs ----
#
# A spec is a dict: ``driver`` ("adaptive", "forced" or "fused"), the model,
# state and driver arguments, and for "adaptive" the rhs and whether the
# model's policies are applied (``policies``).


def _infiltration():
    """``test_adaptive.py:43``: sand infiltration, nz=150."""
    from landhydrology_tpu.models.soil.rhs import make_rhs
    from tests import test_adaptive as ta

    model = ta._infiltration_model()
    Y, Ya = ta.initialize_states(model, lambda z, m: {"vartheta_l": jnp.full_like(z, 0.1),
                                                      "theta_i": jnp.zeros_like(z)}, 0.0)
    return dict(driver="adaptive", model=model, Y=Y, Ya=Ya, rhs=make_rhs(model, make_function_space(model.domain)),
                tf=120.0, dt0=0.01, stepper=SSPRK33(), config=AdaptiveConfig(rtol=1e-6, atol=1e-9))


def stiff_model():
    """``test_adaptive.py:83``'s saturated column (nz=40) and its hydrostatic state."""
    from landhydrology_tpu import (
        Column, Dirichlet, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, SoilHydrologyModel,
        SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu.models.soil import vanGenuchten
    from landhydrology_tpu.models.soil.water import hydrostatic_profile

    hm = vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=40), energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=Dirichlet(
                lambda t: hydrostatic_profile(hm, jnp.asarray(-2.0), -0.5, 0.45, 1e-3)))),
        soil_param_set=SoilParams(nu=0.45, S_s=1e-3))
    Y, Ya = initialize_states(model, lambda z, m: {"vartheta_l": hydrostatic_profile(hm, z, -0.5, 0.45, 1e-3),
                                                   "theta_i": jnp.zeros_like(z)}, 0.0)
    return model, Y, Ya


def _stiff():
    """``test_adaptive.py:83``: the saturated column, 40x past its explicit limit."""
    from landhydrology_tpu.models.soil.rhs import make_rhs

    model, Y, Ya = stiff_model()
    return dict(driver="adaptive", model=model, Y=Y, Ya=Ya, rhs=make_rhs(model, make_function_space(model.domain)),
                tf=60.0, dt0=6.0, stepper=SSPRK33(), config=AdaptiveConfig())


def _batched():
    """``test_adaptive.py:160``'s run_adaptive (the XLA engine its fused run
    at steps_per_call=1 equals): 8 columns of nz=40."""
    from landhydrology_tpu.models.soil.rhs import make_rhs
    from tests import test_adaptive as ta

    model = ta._batched_infiltration()
    Y, Ya = ta._batched_ic(model)
    return dict(driver="adaptive", model=model, Y=Y, Ya=Ya, rhs=make_rhs(model), tf=30.0, dt0=0.05,
                stepper=SSPRK33(), config=AdaptiveConfig(rtol=1e-5, atol=1e-8))


def _segments():
    """``test_adaptive.py:191``: the fused run at steps_per_call=6, and the
    fine fixed-dt reference (dt = 0.05)."""
    from tests import test_adaptive as ta

    model = ta._batched_infiltration()
    Y, Ya = ta._batched_ic(model)
    return dict(driver="fused", model=model, Y=Y, Ya=Ya, tf=60.0, dt0=0.02, stepper=SSPRK33(),
                config=AdaptiveConfig(rtol=1e-6, atol=1e-9), steps_per_call=6, tile_cols=8,
                fine=dict(dt=0.05, n=1200))


def _land(tf, dt0, rtol, atol):
    from landhydrology_tpu.models.land import make_rhs as make_land_rhs
    from tests import test_adaptive as ta

    land, Y, Ya = ta._tiny_land()
    return dict(driver="adaptive", model=land, Y=Y, Ya=Ya, rhs=make_land_rhs(land), tf=tf, dt0=dt0,
                stepper=SSPRK33(), config=AdaptiveConfig(rtol=rtol, atol=atol), policies=True)


def _trbdf2_order():
    """``tests/soil/test_imex.py:446``: TR-BDF2 (iters=3) on the stiff coupled
    column, and the fine fixed-dt reference (iters=4, tf/256)."""
    from landhydrology_tpu.models.soil.rhs import make_rhs
    from tests.soil import test_imex as ti

    model = ti._stiff_coupled_model()
    Y, Ya = ti._stiff_coupled_state(model)
    grid = make_function_space(model.domain, jnp.float64)
    return dict(driver="adaptive", model=model, Y=Y, Ya=Ya, rhs=make_rhs(model, grid), tf=6000.0, dt0=300.0,
                stepper=TRBDF2Soil(model=model, grid=grid, iters=3), config=AdaptiveConfig(rtol=1e-6, atol=1e-10),
                fine=dict(stepper=TRBDF2Soil(model=model, grid=grid, iters=4), dt=6000.0 / 256, n=256))


def _forced(driver, n_rows, seed, dt0, config, dt_forcing=240.0, fine=None, stepper=None, **kw):
    from tests import test_forcing_driver as tfd

    model = tfd._atmos_soil()
    Y, Ya = tfd.initialize_states(model, tfd._ic, 0.0)
    tables = tfd._pulse_tables(n_rows, np.random.default_rng(seed))
    return dict(driver=driver, model=model, Y=Y, Ya=Ya, tf=n_rows * dt_forcing, dt0=dt0,
                stepper=stepper or SSPRK33(), config=config, forcing=tables, forcing_dt=dt_forcing,
                fine=fine, **kw)


def _forced_trbdf2():
    """``test_forcing_driver.py:478``: TR-BDF2 (iters=2, PCR) under the pulse
    rows, the XLA engine (which its fused run matches)."""
    from tests import test_forcing_driver as tfd

    model = tfd._atmos_soil()
    stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, jnp.float64), iters=2, tridiag="pcr")
    return _forced("forced", 6, 13, 120.0, AdaptiveConfig(rtol=1e-6, atol=1e-10, dt_max=300.0), dt_forcing=600.0,
                   stepper=stepper)


#: the JAX package's adaptive tests, by the name of their golden keys
CASES = {
    "infiltration": _infiltration,
    "stiff": _stiff,
    "batched": _batched,
    "segments": _segments,
    # test_adaptive.py:327 and :355 at tf = 30 s instead of 120 s and 60 s
    "land6": lambda: _land(30.0, 1.0, 1e-6, 1e-9),
    "land7": lambda: _land(30.0, 2.0, 1e-5, 1e-8),
    "trbdf2_order": _trbdf2_order,
    # test_forcing_driver.py:345, with its fine fixed-dt reference (dt = 30)
    "forced_fine": lambda: _forced("forced", 12, 5, 60.0, AdaptiveConfig(rtol=1e-7, atol=1e-12, dt_max=60.0),
                                   fine=dict(dt=30.0, n=96)),
    # test_forcing_driver.py:398, the XLA engine (which its fused run matches)
    "forced_fused": lambda: _forced("forced", 8, 9, 60.0, AdaptiveConfig(rtol=1e-5, atol=1e-10, dt_max=240.0)),
    # test_forcing_driver.py:428: the fused run at steps_per_call=4, and the fine reference
    "forced_segments": lambda: _forced("fused", 8, 11, 30.0, AdaptiveConfig(rtol=1e-7, atol=1e-12, dt_max=60.0),
                                       fine=dict(dt=30.0, n=64), steps_per_call=4, tile_cols=16),
    "forced_trbdf2": _forced_trbdf2,
}


def _wrapped_stepper(spec):
    """The stepper run_adaptive steps with: the model's policies where the
    spec applies them (run_adaptive(model=...))."""
    from landhydrology_tpu.models.land import wrap_stepper_for_land
    from landhydrology_tpu.parallel.stepping import _wrap_freeze_thaw

    st = spec["stepper"]
    if spec.get("policies"):
        st = wrap_stepper_for_land(_wrap_freeze_thaw(st, spec["model"]), spec["model"])
    return st


def drive(spec, max_steps=None, Y=None):
    """The JAX driver's run of ``spec``: ``(Y_final, stats)``."""
    Y = spec["Y"] if Y is None else Y
    cfg = spec["config"] if max_steps is None else dataclasses.replace(spec["config"], max_steps=max_steps)
    args = (Y, spec["Ya"], 0.0, spec["tf"], spec["dt0"])
    if spec["driver"] == "adaptive":
        return run_adaptive(spec["rhs"], *args, stepper=spec["stepper"], config=cfg,
                            model=spec["model"] if spec.get("policies") else None)
    if spec["driver"] == "forced":
        return run_adaptive_forced(spec["model"], *args, forcing=spec["forcing"], forcing_dt=spec["forcing_dt"],
                                   stepper=spec["stepper"], config=cfg, engine="xla")
    extra = {"forcing": spec["forcing"], "forcing_dt": spec["forcing_dt"]} if "forcing" in spec else {}
    return run_adaptive_fused(spec["model"], *args, stepper=spec["stepper"], config=cfg,
                              steps_per_call=spec["steps_per_call"], tile_cols=spec["tile_cols"], interpret=True,
                              **extra)


def _segment(spec):
    """``(segment(Y, t, dt), steps per segment, the stepper whose order sets
    the PI exponents, dtype)`` of the driver of ``spec``."""
    model = spec["model"]
    if spec["driver"] == "adaptive":
        st = _wrapped_stepper(spec)
        return (lambda Y, t, dt: st.step(spec["rhs"], Y, spec["Ya"], t, dt)), 1, st, jnp.float64
    tables = {k: jnp.asarray(v, jnp.float64) for k, v in spec.get("forcing", {}).items()}
    if spec["driver"] == "forced":
        from landhydrology_tpu.runtime.forcing_driver import TimeForcedStepper

        st = TimeForcedStepper(inner=spec["stepper"], model=model, grid=make_function_space(model.domain),
                               tables=tables, t_start=0.0, dt_forcing=float(spec["forcing_dt"]))
        return (lambda Y, t, dt: st.step(None, Y, spec["Ya"], t, dt)), 1, st, jnp.float64
    from landhydrology_tpu.ops.pallas import make_fused_column_run

    kw = {}
    if tables:
        kw = dict(forcing_fields=tuple(sorted(tables)),
                  forcing_time_grid=(0.0, float(spec["forcing_dt"]), next(iter(tables.values())).shape[0]))
    dtype = model.float_dtype
    fused = make_fused_column_run(model, spec["stepper"], dt=float(jnp.asarray(spec["dt0"], dtype)),
                                  steps_per_call=spec["steps_per_call"], tile_cols=spec["tile_cols"],
                                  interpret=True, **kw)
    return (lambda Y, t, dt: fused(Y, t, forcing=tables or None, dt_run=dt)), spec["steps_per_call"], \
        spec["stepper"], dtype


def records(spec, keep_at=None, Y=None):
    """The driver of ``spec`` as a Python loop over its step-doubling body
    (jitted once) and ``run_adaptive``'s controller arithmetic:
    ``(records, state after keep_at iterations, final state, stats)``;
    each record is ``(t, dt, err, accept)``."""
    segment, spc, st, dtype = _segment(spec)
    cfg = spec["config"]
    p1 = float(getattr(st, "order", 3)) + 1.0
    k_p, k_i = 0.7 / p1, 0.4 / p1

    def err_norm(Y1, Y2, Yref):
        def leaf(a, b, r):
            return jnp.max(jnp.abs(a - b) / (cfg.atol + cfg.rtol * jnp.maximum(jnp.abs(r), jnp.abs(b))))

        return jax.tree_util.tree_reduce(jnp.maximum, jax.tree_util.tree_map(leaf, Y1, Y2, Yref))

    @jax.jit
    def body(Y, t, dt):
        Y1 = segment(Y, t, dt)
        Y2 = segment(segment(Y, t, 0.5 * dt), t + 0.5 * spc * dt, 0.5 * dt)
        return Y2, jnp.maximum(err_norm(Y1, Y2, Y), 1e-12)

    Y = spec["Y"] if Y is None else Y
    t, tf = jnp.asarray(0.0, dtype), jnp.asarray(spec["tf"], dtype)
    dt, err_prev = jnp.asarray(spec["dt0"], dtype), jnp.asarray(1.0, dtype)
    out, Y_k, n_acc, n_rej = [], None, 0, 0
    while bool(t < tf - 1e-12 * jnp.maximum(jnp.abs(tf), 1.0)) and len(out) < cfg.max_steps:
        dt = jnp.minimum(dt, tf - t) if spc == 1 else jnp.minimum(dt, (tf - t) / spc)
        Y2, err = body(Y, t, dt)
        accept = bool(jnp.logical_or(err <= 1.0, dt <= cfg.dt_min * (1.0 + 1e-9)))
        factor = cfg.safety * err ** (-k_p) * err_prev ** (k_i)
        factor = jnp.where(jnp.isfinite(factor), factor, cfg.max_shrink)
        factor = jnp.clip(factor, cfg.max_shrink, cfg.max_growth)
        out.append((float(t), float(dt), float(err), accept))
        if accept:
            Y, t = Y2, t + spc * dt
            err_prev = jnp.where(jnp.isfinite(err), err, 1.0)
            n_acc += 1
        else:
            n_rej += 1
        dt = jnp.clip(dt * factor, cfg.dt_min, cfg.dt_max)
        if len(out) == keep_at:
            Y_k = Y
    return out, Y_k, Y, dict(n_accepted=n_acc, n_rejected=n_rej, dt_final=float(dt))


def _fine(spec):
    """The fixed-dt reference of ``spec``'s JAX test: ``n`` steps of ``dt``
    (forced: the table's rows repeated onto that step grid)."""
    from landhydrology_tpu.runtime import make_forced_segment_run

    fine = spec["fine"]
    if "forcing" in spec:
        m = int(round(spec["forcing_dt"] / fine["dt"]))
        rows = {k: jnp.asarray(np.repeat(v, m, axis=0)) for k, v in spec["forcing"].items()}
        Yf, _ = make_forced_segment_run(spec["model"], SSPRK33(), dt=fine["dt"], field_names=sorted(rows))(
            spec["Y"], spec["Ya"], 0.0, rows)
        return Yf
    from landhydrology_tpu.models.soil.rhs import make_rhs

    st = fine.get("stepper", SSPRK33())
    rhs = make_rhs(spec["model"], make_function_space(spec["model"].domain, jnp.float64))

    @jax.jit
    def go(Y):
        def body(carry, _):
            Yc, t = carry
            return (st.step(rhs, Yc, spec["Ya"], t, jnp.float64(fine["dt"])), t + fine["dt"]), None

        (Yf, _), _ = jax.lax.scan(body, (Y, jnp.float64(0.0)), None, length=fine["n"])
        return Yf

    return go(spec["Y"])


def _same_run(stats, Yf, loop_stats, Y_end):
    """Whether the iteration loop ended on the driver's counts, dt_final and
    state, bit for bit."""
    same = loop_stats == dict(n_accepted=int(stats["n_accepted"]), n_rejected=int(stats["n_rejected"]),
                              dt_final=float(stats["dt_final"]))
    leaves = zip(jax.tree_util.tree_leaves(Y_end), jax.tree_util.tree_leaves(Yf))
    return same and all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in leaves)


def case_a(max_steps=None, ulp=None):
    model, Y, Ya, _ = build_model_and_state(jnp.float64)
    Y = _bump(Y, ulp)
    cfg = AdaptiveConfig(rtol=A["rtol"], atol=A["atol"])
    if max_steps is not None:
        cfg = dataclasses.replace(cfg, max_steps=max_steps)
    return run_adaptive_fused(model, Y, Ya, 0.0, A["tf"], A["dt0"], stepper=SSPRK33(), config=cfg,
                              steps_per_call=A["steps_per_call"], tile_cols=8, interpret=True)


def case_b_spec():
    model, Y, Ya, rows, _ = build_forced_model_state_and_rows(jnp.float64)
    stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, jnp.float64), iters=B["iters"])
    return dict(driver="forced", model=model, Y=Y, Ya=Ya, tf=B["tf"], dt0=B["dt0"], stepper=stepper,
                config=AdaptiveConfig(rtol=B["rtol"], atol=B["atol"]), forcing=rows, forcing_dt=B["forcing_dt"])


def case_b(ulp=None):
    spec = case_b_spec()
    return drive(spec, Y=_bump(spec["Y"], ulp))


def main():
    out = {}
    Yf, stats = case_a()
    n_iter = int(stats["n_accepted"]) + int(stats["n_rejected"])
    out.update(a_n_accepted=int(stats["n_accepted"]), a_n_rejected=int(stats["n_rejected"]),
               a_dt_final=float(stats["dt_final"]))
    for k, v in Yf["soil"].items():
        out[f"a_{k}"] = np.asarray(v)
    dt_seq, acc_seq = [], []
    for k in range(1, n_iter + 1):
        _, s = case_a(max_steps=k)
        dt_seq.append(float(s["dt_final"]))
        acc_seq.append(int(s["n_accepted"]))
        print(f"case a: iteration {k}/{n_iter}: dt {dt_seq[-1]!r}, accepted {acc_seq[-1]}", flush=True)
    out.update(a_dt_seq=np.asarray(dt_seq), a_acc_seq=np.asarray(acc_seq))

    spec = case_b_spec()
    Yf, stats = drive(spec)
    out.update(b_n_accepted=int(stats["n_accepted"]), b_n_rejected=int(stats["n_rejected"]),
               b_dt_final=float(stats["dt_final"]))
    for k, v in Yf["soil"].items():
        out[f"b_{k}"] = np.asarray(v)
    recs, Y_k, Y_end, loop_stats = records(spec, keep_at=B_K)
    if not _same_run(stats, Yf, loop_stats, Y_end):
        raise AssertionError(f"case b: the iteration loop ended on {loop_stats}, not on the driver's run")
    t_seq, dt_seq, err_seq, acc_seq = zip(*recs)
    out.update(b_seq_t=np.asarray(t_seq), b_seq_dt=np.asarray(dt_seq), b_seq_err=np.asarray(err_seq),
               b_seq_accept=np.asarray(acc_seq), b_k=B_K)
    for k, v in Y_k["soil"].items():
        out[f"b_k_{k}"] = np.asarray(v)

    for case, runs, fn in (("a", A_ULP, case_a), ("b", B_ULP, case_b)):
        ref = {k[len(case) + 1:]: v for k, v in out.items()
               if k.startswith(f"{case}_") and k[len(case) + 1:] in ("vartheta_l", "theta_i", "rho_e_int")}
        rows = []
        for ulp in runs:
            Yp, s = fn(ulp=ulp)
            rows.append((int(s["n_accepted"]), int(s["n_rejected"]), float(s["dt_final"]), _deviation(Yp, ref)))
            print(f"case {case}, {ulp} one ulp: {rows[-1]}", flush=True)
        n_acc, n_rej, dt_f, dev = (np.asarray(c) for c in zip(*rows))
        out.update({f"{case}_ulp_n_accepted": n_acc, f"{case}_ulp_n_rejected": n_rej,
                    f"{case}_ulp_dt_final": dt_f, f"{case}_ulp_state_dev": dev})

    for name, make in CASES.items():
        spec = make()
        Yf, stats = drive(spec)
        recs, _, Y_end, loop_stats = records(spec)
        same = _same_run(stats, Yf, loop_stats, Y_end)
        out.update({f"{name}__n_accepted": int(stats["n_accepted"]), f"{name}__n_rejected": int(stats["n_rejected"]),
                    f"{name}__dt_final": float(stats["dt_final"])})
        for group, fields in Yf.items():
            for k, v in fields.items():
                out[f"{name}__{group}__{k}"] = np.asarray(v)
        for group, fields in Y_end.items():
            for k, v in fields.items():
                out[f"{name}__replay__{group}__{k}"] = np.asarray(v)
        for j, key in enumerate(("t", "dt", "err", "accept")):
            out[f"{name}__seq_{key}"] = np.asarray([r[j] for r in recs])
        if spec.get("fine"):
            for group, fields in _fine(spec).items():
                for k, v in fields.items():
                    out[f"{name}__fine__{group}__{k}"] = np.asarray(v)
        print(f"{name}: {out[f'{name}__n_accepted']} accepted, {out[f'{name}__n_rejected']} rejected, "
              f"dt_final {out[f'{name}__dt_final']!r}; the iteration loop {loop_stats}, "
              f"{'bit for bit the driver' if same else 'not bit for bit the driver'}", flush=True)

    path = os.path.join(os.path.dirname(__file__), "golden_adaptive_f64.npz")
    np.savez(path, **out)
    print(f"wrote {path}: case a {out['a_n_accepted']} accepted, {out['a_n_rejected']} rejected; "
          f"case b {out['b_n_accepted']} accepted, {out['b_n_rejected']} rejected")


if __name__ == "__main__":
    main()
