"""Generate the gradient golden (``golden_grad_f64.npz``; run once, output
committed) with the JAX package on the CPU in f64.

For each case of ``GRAD_CASES`` (``golden_config_torch.py``) it runs one
launch of ``make_fused_column_run(..., interpret=True, differentiable=True)``
(kernel mode B9: the Pallas kernel's forward, the XLA replay's vjp) from the
case's start state and stores, under ``<case>__``:

- ``loss``: ``grad_loss`` of the final state (``GRAD_TARGET``,
  ``GRAD_SCALE``);
- ``g_<field>``: the gradient in each field of the start state;
- ``g_t0``, ``g_dt``: the gradients in the launch's start time and its
  ``dt_run``;
- ``y0_<field>``: the start state, for the builders of
  ``golden_config_torch.build_grad_case`` to be held against.

It also freezes ``jax.jit(jax.grad(...))`` of the eager engine's steps under
``lax.scan`` (the JAX tests' form) for each case of ``SWEEP``, keys
``sweep__<case>__``: ``loss``, ``g_t0``, ``g_dt`` and ``g_<group>__<field>``,
the loss being ``sum(W * Y_final)`` over every state field with the weights
``golden_config_torch.sweep_weights(Y0)``.  ``sweep_case`` builds each
case's JAX model, state and stepper; the port's tests carry them over with
``convert.model_from_reference`` (the compile of ``jax.grad`` over the
implicit steppers takes a minute or more per case, too long for a test).

For the MOST top face it freezes the JAX package's *forward* differenced,
keys ``most__<case>__`` for each case of ``MOST_CASES``: the loss, three
seeded directions ``dir<i>_<group>__<field>``, the fourth-order central
differences of the loss along them (``fd``) and along dt (``fd_dt``); and
``most__surface__``: 32 surface temperatures ``T`` and the central
differences of ``surface_conditions``' 1/L and u* in them (``fd_Linv``,
``fd_ustar``).  ``jax.grad`` there differentiates the solve's last
false-position step on a bracket one ulp wide, which is no derivative of
the root, so the port's gradient is held to these differences.

Usage: python tests/data/make_golden_grad.py [b9] [sweep] [most]
(all three by default, about ten minutes; with some named, the keys of the
others are kept from the existing file)
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

from tests.data import golden_config as gc
from tests.data.golden_config_torch import (
    GRAD_CASES, MOST_CASES, MOST_FD_DIRS, MOST_FD_DT_STEP, MOST_FD_STEP, grad_loss, sweep_weights,
)

OUT = os.path.join(os.path.dirname(__file__), "golden_grad_f64.npz")


def jax_column():
    """``test_differentiability.py:115``'s model and start state."""
    from landhydrology_tpu import (
        Column, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu.models.soil import vanGenuchten

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=8, batch_shape=(16,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(-1e-7)),
            bottom=SoilComponentBC(hydrology=FreeDrainage())),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
    )
    Y, _ = initialize_states(model, lambda z, m: {
        "vartheta_l": 0.2 + 0.03 * jnp.sin(3.0 * z) + 0 * z, "theta_i": jnp.zeros_like(z)}, 0.0)
    return model, Y


def jax_case(case):
    from landhydrology_tpu.domains import make_function_space
    from landhydrology_tpu.imex import TRBDF2Soil
    from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu.timestepping import SSPRK33

    if case["build"] == "column":
        model, Y = jax_column()
    elif case["build"] == "golden1":
        model, Y, _, _ = gc.build_model_and_state(jnp.float64)
    else:
        model, Y, _, _ = gc.build_freeze_model_and_state(jnp.float64)
        freeze = FreezeThaw(tau=60.0) if case["freeze"] == "rate" else EquilibriumFreezeThaw()
        model = dataclasses.replace(model, freeze_thaw=freeze,
                                    coefficient_update="step" if case["lagged"] else "stage")
    if case["stepper"] == "SSPRK33":
        stepper = SSPRK33()
    else:
        stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, jnp.float64), iters=2)
    return model, Y, stepper


#: the eager sweep: (configuration, stepper, model options, steps, dt)
SWEEP = {
    "g1_ssprk33": ("golden1", "SSPRK33", {}, 6, 10.0),
    "g1_trbdf2": ("golden1", "TRBDF2Soil/thomas", {}, 3, 120.0),
    "g1_trbdf2_pcr": ("golden1", "TRBDF2Soil/pcr", {}, 3, 120.0),
    "g1_be_soil": ("golden1", "BackwardEulerSoil/thomas", {}, 3, 120.0),
    "g1_be_richards": ("golden1", "BackwardEulerRichards/thomas", {}, 3, 120.0),
    "g1_no_ice": ("golden1", "SSPRK33", {"assume_no_ice": True}, 6, 10.0),
    "freeze_rate": ("freeze", "SSPRK33", {"freeze": "rate"}, 6, 5.0),
    "freeze_rate_lagged": ("freeze", "SSPRK33", {"freeze": "rate", "coefficient_update": "step"}, 6, 5.0),
    "freeze_eq": ("freeze", "SSPRK33", {"freeze": "eq"}, 6, 5.0),
    "freeze_eq_lagged": ("freeze", "SSPRK33", {"freeze": "eq", "coefficient_update": "step"}, 6, 5.0),
    "heat_only": ("heat", "SSPRK33", {}, 6, 10.0),
    "water_only": ("water", "SSPRK33", {}, 6, 10.0),
    "kinds": ("kinds", "SSPRK33", {}, 6, 10.0),
    "variable_depth": ("depths", "SSPRK33", {}, 8, 0.25),
    "forced_pond": ("forced", "SSPRK33", {}, 6, 10.0),
}
#: the forced case's rain rows (one per step and column)
FORCED_RAIN = 8e-6


def _golden1_branch(branch):
    """Golden #1 with one component prescribed, and its start state."""
    from landhydrology_tpu import (
        NoBC, PrescribedHydrologyModel, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
        initialize_states,
    )

    model, Y, _, _ = gc.build_model_and_state(jnp.float64)
    bcs = model.boundary_conditions
    if branch == "water":
        model = dataclasses.replace(
            model, energy_model=PrescribedTemperatureModel(T_profile=lambda z, t: 285.0 + 4.0 * z + 0.0 * t),
            boundary_conditions=SoilColumnBC(
                top=SoilComponentBC(hydrology=bcs.top.hydrology),
                bottom=SoilComponentBC(hydrology=bcs.bottom.hydrology, energy=NoBC())))
        keep = ("vartheta_l", "theta_i")
    else:
        model = dataclasses.replace(
            model, hydrology_model=PrescribedHydrologyModel(
                vartheta_l_profile=lambda z, t: 0.3 + 0.05 * z + 0.0 * t),
            boundary_conditions=SoilColumnBC(top=SoilComponentBC(energy=bcs.top.energy),
                                             bottom=SoilComponentBC(energy=bcs.bottom.energy)))
        keep = ("rho_e_int",)
    Yb, Ya = initialize_states(model, lambda z, m: {k: Y["soil"][k] for k in keep}, 0.0)
    return model, Yb, Ya


def _kinds_case():
    """Per-column BC kinds (``BatchedBC``) at the top's water slot under a
    time-dependent energy Dirichlet (``test_torch_heterogeneity.py``'s
    ``energy_plain`` case), six coupled columns."""
    from landhydrology_tpu import (
        BatchedBC, Column, Dirichlet, FreeDrainage, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu.constants import default_earth_param_set as ps
    from landhydrology_tpu.models.soil import vanGenuchten
    from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    kinds = jnp.array([0, 1, 1, 0, 1, 0], dtype=jnp.int32)
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=12, batch_shape=(6,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.2, alpha=2.6, Ksat=2e-6,
                                                                        theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=BatchedBC(kind=kinds, value=jnp.where(kinds == 1, 0.40, -2e-7)),
                                energy=Dirichlet(lambda t: 293.0 + 1e-3 * t)),
            bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0))),
        soil_param_set=SoilParams(nu=0.45, S_s=1e-3, rho_c_ds=1.3e6),
    )
    rng = np.random.default_rng(3)
    theta = jnp.asarray(0.2 + 0.1 * rng.random((12, 6)))
    ti = jnp.zeros_like(theta)
    T = jnp.asarray(283.0 + 6.0 * rng.random((12, 6)))
    Y, Ya = initialize_states(model, lambda z, m: {
        "vartheta_l": theta, "theta_i": ti,
        "rho_e_int": volumetric_internal_energy(ti, volumetric_heat_capacity(theta, ti, 1.3e6, ps), T, ps)}, 0.0)
    return model, Y, Ya


def _depths_case():
    """``test_variable_depth.py:100``'s mixed-depth Richards batch (0.8, 1.5
    and 3.0 m, nz=24, a Dirichlet top over free drainage)."""
    from landhydrology_tpu import (
        Dirichlet, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
        SoilHydrologyModel, SoilModel, SoilParams, initialize_states,
    )
    from landhydrology_tpu.domains import VariableDepthColumn
    from landhydrology_tpu.models.soil import vanGenuchten

    model = SoilModel(
        domain=VariableDepthColumn(z_bottom=-jnp.asarray([0.8, 1.5, 3.0]), nelements=24, batch_shape=(3,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5,
                                                                        theta_r=0.075)),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.24)),
                                         bottom=SoilComponentBC(hydrology=FreeDrainage())),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3),
    )
    return (model, *initialize_states(
        model, lambda z, m: {"vartheta_l": jnp.full_like(z, 0.12), "theta_i": jnp.zeros_like(z)}, 0.0))


def _forced_case():
    """Golden #1's soil under a LandModel pond (zero-flux water top, so the
    pond's infiltration is the top's water flux) with per-column rain rows,
    ``h_s0`` = 1 mm."""
    from landhydrology_tpu import SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu.models import land

    model, Y, _, _ = gc.build_model_and_state(jnp.float64)
    bcs = model.boundary_conditions
    soil = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=bcs.top.energy), bottom=bcs.bottom))
    lm = land.LandModel(soil=soil, surface=land.SurfaceWaterModel(tau_pond=240.0))
    Yl, Ya = land.initialize_states(lm, lambda z, m: dict(Y["soil"]), 0.0, h_s0=1e-3)
    return lm, Yl, Ya


def forced_rows(n_steps, ncol):
    """The forced case's rain rows: ``FORCED_RAIN`` times a fixed pattern."""
    return {"precipitation": FORCED_RAIN * np.random.default_rng(11).random((n_steps, ncol))}


def sweep_case(name):
    """``(model, Y, Ya, stepper, steps, dt, rows)`` of sweep case ``name``
    in the JAX package (``rows``: forcing rows of the forced case, else
    ``None``)."""
    from landhydrology_tpu.imex import BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil
    from landhydrology_tpu.domains import make_function_space
    from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu.timestepping import SSPRK33

    build, stepper, options, steps, dt = SWEEP[name]
    options = dict(options)
    rows = None
    if build == "golden1":
        model, Y, Ya, _ = gc.build_model_and_state(jnp.float64)
    elif build == "freeze":
        model, Y, Ya, _ = gc.build_freeze_model_and_state(jnp.float64)
        options["freeze_thaw"] = FreezeThaw(tau=60.0) if options.pop("freeze") == "rate" else EquilibriumFreezeThaw()
    elif build in ("heat", "water"):
        model, Y, Ya = _golden1_branch(build)
    elif build == "kinds":
        model, Y, Ya = _kinds_case()
    elif build == "depths":
        model, Y, Ya = _depths_case()
    else:
        model, Y, Ya = _forced_case()
        rows = forced_rows(steps, model.soil.domain.batch_shape[0])
    if options:
        model = dataclasses.replace(model, **options)
    if stepper == "SSPRK33":
        st = SSPRK33()
    else:
        cls, tridiag = stepper.split("/")
        st = {"TRBDF2Soil": TRBDF2Soil, "BackwardEulerSoil": BackwardEulerSoil,
              "BackwardEulerRichards": BackwardEulerRichards}[cls](
            model=model, grid=make_function_space(model.domain, jnp.float64), iters=2, tridiag=tridiag)
    return model, Y, Ya, st, steps, dt, rows


def _sweep_grads(name):
    """``(loss, (d Y0, d t0, d dt))`` of sweep case ``name`` by
    ``jax.jit(jax.grad(...))`` over ``lax.scan``."""
    from landhydrology_tpu import Simulation
    from landhydrology_tpu.domains import make_function_space
    from landhydrology_tpu.models.soil.rhs import make_rhs
    from landhydrology_tpu.runtime.forcing_driver import make_forced_segment_run

    model, Y, Ya, st, steps, dt, rows = sweep_case(name)
    W = jax.tree_util.tree_map(jnp.asarray, sweep_weights(jax.tree_util.tree_map(np.asarray, Y)))

    def total(Yf):
        return sum(jnp.sum(W[g][k] * Yf[g][k]) for g in Yf for k in Yf[g])

    if rows is not None:
        seg = make_forced_segment_run(model, st, dt=dt, field_names=tuple(rows))

        def loss(Y0, t0, dt_):  # the segment closes over its dt: d dt is not taken here
            return total(seg(Y0, Ya, t0, rows)[0]) + 0.0 * dt_
    else:
        wrapped = Simulation(model, st, Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, dt)).stepper
        rhs = make_rhs(model, make_function_space(model.domain, jnp.float64))

        def loss(Y0, t0, dt_):
            def body(carry, _):
                Yc, t = carry
                return (wrapped.step(rhs, Yc, Ya, t, dt_), t + dt_), None

            (Yf, _), _ = jax.lax.scan(body, (Y0, t0), None, length=steps)
            return total(Yf)

    args = (Y, jnp.asarray(0.0, jnp.float64), jnp.asarray(dt, jnp.float64))
    value = jax.jit(loss)(*args)
    return value, jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)


def _fd4(f, h):
    """Fourth-order central difference at 0 of the scalar function ``f``
    with step ``h``."""
    return (f(-2 * h) - 8 * f(-h) + 8 * f(h) - f(2 * h)) / (12 * h)


def most_case(name):
    """``(loss, Y, steps)`` of MOST case ``name`` in the JAX package:
    ``loss(Y0, dt)`` the sweep's weighted sum of the state after the case's
    steps from t0 = 0 (jitted), the stepper wrapped as ``Simulation`` wraps
    it for the soil, bare SSPRK33 on the LandModel (as the port's tests
    step it)."""
    from landhydrology_tpu import Column, Simulation, initialize_states
    from landhydrology_tpu.domains import make_function_space
    from landhydrology_tpu.imex import TRBDF2Soil
    from landhydrology_tpu.models import land as jland
    from landhydrology_tpu.models.soil.rhs import make_rhs
    from landhydrology_tpu.timestepping import SSPRK33

    case = MOST_CASES[name]
    lm, Y, Ya, _ = gc.build_land_model_and_state(jnp.float64)
    if case["model"] == "land":
        model = dataclasses.replace(lm, surface=dataclasses.replace(lm.surface, runoff=None))
        rhs, st = jland.make_rhs(model), SSPRK33()
    else:
        model = dataclasses.replace(
            lm.soil, domain=Column(zlim=(-1.5, 0.0), nelements=gc.LAND_NZ, batch_shape=(gc.LAND_NX * gc.LAND_NY,)),
            coefficient_update="step" if case["lagged"] else "stage")
        Y, Ya = initialize_states(model, lambda z, m: {k: v.reshape(gc.LAND_NZ, -1) for k, v in Y["soil"].items()},
                                  0.0)
        grid = make_function_space(model.domain, jnp.float64)
        rhs = make_rhs(model, grid)
        st = SSPRK33() if case["stepper"] == "SSPRK33" else TRBDF2Soil(model=model, grid=grid, iters=2)
        st = Simulation(model, st, Y_init=Y, Ya_init=Ya, dt=case["dt"], tspan=(0.0, case["dt"])).stepper
    W = jax.tree_util.tree_map(jnp.asarray, sweep_weights(jax.tree_util.tree_map(np.asarray, Y)))

    @jax.jit
    def loss(Y0, dt):
        Yc, t = Y0, jnp.asarray(0.0, jnp.float64)
        for _ in range(case["steps"]):
            Yc = st.step(rhs, Yc, Ya, t, dt)
            t = t + dt
        return sum(jnp.sum(W[g][k] * Yc[g][k]) for g in Yc for k in Yc[g])

    return loss, Y, case


def most_golden():
    """The ``most__`` keys: differences of the JAX package's forward."""
    from landhydrology_tpu.constants import default_earth_param_set as ps
    from landhydrology_tpu.models.soil import surface_fluxes as sf

    out = {}
    for name in MOST_CASES:
        loss, Y, case = most_case(name)
        dt = jnp.asarray(case["dt"], jnp.float64)
        Yn = jax.tree_util.tree_map(np.asarray, Y)
        rng = np.random.default_rng(0)
        fds = []
        for i in range(MOST_FD_DIRS):
            d = {g: {k: rng.standard_normal(v.shape) * (float(np.max(np.abs(v))) or 1.0) * (k != "theta_i")
                     for k, v in sorted(Yn[g].items())} for g in sorted(Yn)}
            for g in d:
                for k, v in d[g].items():
                    out[f"most__{name}__dir{i}_{g}__{k}"] = v

            def along(h, d=d):
                return float(loss({g: {k: Yn[g][k] + h * d[g][k] for k in Yn[g]} for g in Yn}, dt))

            fds.append(_fd4(along, MOST_FD_STEP))
        out[f"most__{name}__loss"] = np.asarray(loss(Y, dt))
        out[f"most__{name}__fd"] = np.asarray(fds)
        out[f"most__{name}__fd_dt"] = np.asarray(
            _fd4(lambda h: float(loss(Y, dt * (1.0 + h))), MOST_FD_DT_STEP) / case["dt"])
        print(f"most {name}: loss {float(out[f'most__{name}__loss'])!r}, directional differences {fds!r}, "
              f"d/ddt {float(out[f'most__{name}__fd_dt'])!r}", flush=True)
    T = 285.0 + 30.0 * np.random.default_rng(0).random(32)

    def solve(T_):
        T_ = jnp.asarray(T_)
        r = sf.surface_conditions(ps, 2.0, 300.0, 0.005, 0.0 * T_, T_, 0.004 + 0.0 * T_, 2.0, 0.01, 0.001, 300.0)
        return np.asarray(1.0 / r["L_mo"]), np.asarray(r["x_star"][0])

    out["most__surface__T"] = T
    out["most__surface__fd_Linv"] = _fd4(lambda h: solve(T + h)[0], 1e-3)
    out["most__surface__fd_ustar"] = _fd4(lambda h: solve(T + h)[1], 1e-3)
    return out


def main():
    from landhydrology_tpu.ops.pallas import make_fused_column_run

    parts = sys.argv[1:] or ["b9", "sweep", "most"]
    out = {}
    if set(parts) != {"b9", "sweep", "most"} and os.path.exists(OUT):
        keep = {"b9": lambda k: not k.startswith(("sweep__", "most__")),
                "sweep": lambda k: k.startswith("sweep__"), "most": lambda k: k.startswith("most__")}
        old = np.load(OUT)
        out = {k: old[k] for k in old.files if not any(keep[p](k) for p in parts)}
    for name, case in GRAD_CASES.items() if "b9" in parts else ():
        model, Y, stepper = jax_case(case)
        ncol = model.domain.batch_shape[0]
        run = make_fused_column_run(model, stepper, dt=case["dt"], steps_per_call=case["steps"],
                                    tile_cols=ncol, interpret=True, differentiable=True)
        start = Y["soil"]

        def loss(fields, t0, dt):
            return grad_loss(run({"soil": fields}, t0, dt_run=dt)["soil"], start)

        t0 = jnp.asarray(case["t0"], jnp.float64)
        dt = jnp.asarray(case["dt"], jnp.float64)
        value, (g_fields, g_t0, g_dt) = jax.value_and_grad(loss, argnums=(0, 1, 2))(start, t0, dt)
        out[f"{name}__loss"] = np.asarray(value)
        out[f"{name}__g_t0"] = np.asarray(g_t0)
        out[f"{name}__g_dt"] = np.asarray(g_dt)
        for k, v in start.items():
            out[f"{name}__y0_{k}"] = np.asarray(v)
            out[f"{name}__g_{k}"] = np.asarray(g_fields[k])
        print(f"{name}: loss {float(value)!r}, d/dt0 {float(g_t0)!r}, d/ddt {float(g_dt)!r}, "
              + ", ".join(f"|d/d{k}| {float(jnp.max(jnp.abs(v)))!r}" for k, v in g_fields.items()), flush=True)
    for name in SWEEP if "sweep" in parts else ():
        value, (g_Y, g_t0, g_dt) = _sweep_grads(name)
        out[f"sweep__{name}__loss"] = np.asarray(value)
        out[f"sweep__{name}__g_t0"] = np.asarray(g_t0)
        out[f"sweep__{name}__g_dt"] = np.asarray(g_dt)
        for g, fields in g_Y.items():
            for k, v in fields.items():
                out[f"sweep__{name}__g_{g}__{k}"] = np.asarray(v)
        print(f"sweep {name}: loss {float(value)!r}, d/dt0 {float(g_t0)!r}, d/ddt {float(g_dt)!r}", flush=True)
    if "most" in parts:
        out.update(most_golden())
    np.savez(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
