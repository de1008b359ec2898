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
- ``build_adaptive_case``: the two cases of the adaptive golden
  (``make_golden_adaptive.py``, ``golden_adaptive_f64.npz``), their models,
  states and driver arguments.

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


#: the adaptive golden (``golden_adaptive_f64.npz``, written by
#: ``make_golden_adaptive.py`` with the JAX package).  Case (a): golden #1
#: under ``run_adaptive_fused(SSPRK33(), steps_per_call=4)`` from 0 to
#: ``ADAPTIVE_A["tf"]``; case (b): the forced golden's soil and rows as a
#: time-indexed table under ``run_adaptive_forced(stepper=TRBDF2Soil(iters=2))``.
ADAPTIVE_A = dict(tf=3600.0, dt0=100.0, steps_per_call=4, rtol=1e-8, atol=1e-12)
ADAPTIVE_B = dict(tf=2400.0, dt0=120.0, forcing_dt=60.0, iters=2, rtol=1e-6, atol=1e-10)


def build_adaptive_case(case, dtype, device="cuda"):
    """``(model, Y, Ya, stepper, kwargs)`` of the adaptive golden's case
    ``"a"`` or ``"b"``: the driver is ``run_adaptive_fused(model, Y, Ya, 0.0,
    **kwargs)`` for case (a) and ``run_adaptive_forced(model, Y, Ya, 0.0,
    **kwargs)`` for case (b), each with ``stepper=stepper``."""
    from landhydrology_tpu_torch.adaptive import AdaptiveConfig
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import TRBDF2Soil
    from landhydrology_tpu_torch.timestepping import SSPRK33

    if case == "a":
        p = ADAPTIVE_A
        model, Y, Ya, _ = build_model_and_state(dtype, device)
        return model, Y, Ya, SSPRK33(), dict(
            tf=p["tf"], dt0=p["dt0"], steps_per_call=p["steps_per_call"],
            config=AdaptiveConfig(rtol=p["rtol"], atol=p["atol"]))
    if case != "b":
        raise ValueError(f"unknown adaptive golden case {case!r}")
    p = ADAPTIVE_B
    model, Y, Ya, rows, _ = build_forced_model_state_and_rows(dtype, device)
    stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, dtype, device), iters=p["iters"])
    return model, Y, Ya, stepper, dict(
        tf=p["tf"], dt0=p["dt0"], forcing=rows, forcing_dt=p["forcing_dt"],
        config=AdaptiveConfig(rtol=p["rtol"], atol=p["atol"]))


#: two implementations' error norms at the same step may differ by this many
#: units of rounding of the state over ``rtol`` (the norm divides a
#: difference of two states by ``rtol`` times the state), plus as many of
#: the norm itself
ERR_NOISE_ULPS = 64
#: a free run may stray from the adaptive golden by this multiple of the
#: farthest the reference strays when one field of its initial state moves
#: by one ulp (``*_ulp_*`` of the golden)
ULP_SPREAD = 2.0


def _field_deviation(state, ref):
    """The largest deviation of any field relative to that field's largest value."""
    return max(float(np.max(np.abs(state[k] - ref[k]))) / (float(np.max(np.abs(ref[k]))) or 1.0) for k in ref)


def _fields(golden, prefix):
    return {k: golden[f"{prefix}{k}"] for k in ("vartheta_l", "theta_i", "rho_e_int")}


def check_adaptive_run(golden, case, stats, state, log=None):
    """Hold a free run of the adaptive golden's case ``"a"`` or ``"b"``
    (``stats`` as the drivers return them, ``state`` the final soil fields
    as float64 arrays, ``log`` the run's iteration records) against the
    golden; returns ``{what: (deviation, bar)}`` and raises
    ``AssertionError`` past a bar.

    The error norm subtracts two solutions that agree to about ``rtol``,
    so rounding moves each run's dt, and the PI controller carries that
    forward: two correct implementations that differ in the last bit of a
    step cannot agree on dt to 1e-12.  The bars are therefore the
    reference's own: ``ULP_SPREAD`` times the farthest its reruns from
    one-ulp moves of the initial state land.  Case a: equal counts, the
    accepted count after every iteration equal, every iteration's next dt
    (``a_dt_seq``) and ``dt_final`` within that spread of ``dt_final``
    (relative), the state at rtol 1e-10.  Case b (where the reference's own
    reruns change the counts): counts, ``dt_final`` and the state within
    that spread."""
    ref_state = _fields(golden, f"{case}_")
    n_acc, n_rej = int(stats["n_accepted"]), int(stats["n_rejected"])
    ref_acc, ref_rej = int(golden[f"{case}_n_accepted"]), int(golden[f"{case}_n_rejected"])
    dt_f, ref_dt = float(stats["dt_final"]), float(golden[f"{case}_dt_final"])
    ulp_dt = np.abs(golden[f"{case}_ulp_dt_final"] - ref_dt)
    out = {}

    def hold(what, value, bar):
        out[what] = (value, bar)
        if not value <= bar:
            raise AssertionError(f"adaptive golden case {case}: {what} {value!r} past the bar {bar!r}")

    if case == "a":
        hold("accepted", abs(n_acc - ref_acc), 0)
        hold("rejected", abs(n_rej - ref_rej), 0)
        bar = ULP_SPREAD * float(np.max(ulp_dt)) / ref_dt
        hold("dt_final (relative)", abs(dt_f / ref_dt - 1.0), bar)
        if log is not None:
            seq = np.asarray([r[4] for r in log])
            acc = np.cumsum([bool(r[3]) for r in log])
            if len(seq) != len(golden["a_dt_seq"]):
                raise AssertionError(f"adaptive golden case a: {len(seq)} iterations, the golden "
                                     f"{len(golden['a_dt_seq'])}")
            hold("accepted count after each iteration", int(np.max(np.abs(acc - golden["a_acc_seq"]))), 0)
            hold("dt after each iteration (relative)", float(np.max(np.abs(seq / golden["a_dt_seq"] - 1.0))), bar)
        for k, v in ref_state.items():
            np.testing.assert_allclose(state[k], v, rtol=1e-10, atol=1e-16, err_msg=f"adaptive golden a/{k}")
        out["state (relative to each field's largest value)"] = (_field_deviation(state, ref_state), 1e-10)
        return out
    for what, n, ref, ulp in (("accepted", n_acc, ref_acc, golden["b_ulp_n_accepted"]),
                              ("rejected", n_rej, ref_rej, golden["b_ulp_n_rejected"])):
        hold(what, abs(n - ref), ULP_SPREAD * int(np.max(np.abs(ulp - ref))))
    hold("dt_final (relative)", abs(dt_f / ref_dt - 1.0), ULP_SPREAD * float(np.max(ulp_dt)) / ref_dt)
    hold("state (relative to each field's largest value)", _field_deviation(state, ref_state),
         ULP_SPREAD * float(np.max(golden["b_ulp_state_dev"])))
    return out


def check_replay_errors(records, log, rtol, what, eps=float(np.finfo(np.float64).eps), rel=0.0):
    """Hold the error norms of a replay (``log``) to those of the run it
    replays (``records``): each within ``ERR_NOISE_ULPS`` units of rounding
    (``eps / rtol`` plus ``eps`` times the norm), and the same decision
    where the recorded norm is farther than that from 1.  A step the
    recorded run rejected needs only a norm past 1 as well: a rejected step
    can be unstable (the saturated column of ``test_adaptive.py:83`` from
    40x its explicit limit), which amplifies each implementation's rounding
    within it, and a replay takes the recorded next step all the same.
    ``rel`` adds that share of the recorded norm to the bar, for a run that
    steps at its stability limit throughout.  Returns the largest
    difference over its bar."""
    if len(log) != len(records):
        raise AssertionError(f"{what}: {len(log)} iterations replayed of {len(records)}")
    err = np.asarray([r[2] for r in log])
    ref = np.asarray([r[2] for r in records])
    bar = ERR_NOISE_ULPS * eps * (1.0 / rtol + ref) + rel * ref
    rejected = ~np.asarray([bool(r[3]) for r in records])
    ratio = np.where(rejected & (ref > 1.0 + bar) & (err > 1.0), 0.0, np.abs(err - ref) / bar)
    if not np.all(ratio <= 1.0):  # NaN fails too
        i = int(np.argmax(np.where(np.isnan(ratio), np.inf, ratio)))
        raise AssertionError(f"{what}: iteration {i} error norm {err[i]!r}, the replayed run's {ref[i]!r}")
    decided = np.abs(ref - 1.0) > bar
    mine = np.asarray([bool(r[3]) for r in log])
    if np.any(decided & (mine != np.asarray([bool(r[3]) for r in records]))):
        raise AssertionError(f"{what}: a decision differs where the error norm is clear of 1")
    return float(np.max(ratio))


def check_adaptive_replay(golden, log, state, rtol=ADAPTIVE_B["rtol"]):
    """Hold a replay of case b's iteration records (``b_seq_*``: the same
    start times, steps and decisions) against the golden: every error norm
    in ``log`` within ``ERR_NOISE_ULPS`` units of rounding (``eps / rtol``
    plus ``eps`` times the norm) of the golden's, the same decision where
    the golden's norm is farther than that from 1, and ``state`` after the
    replay at rtol 1e-10 of the golden's: its final state after all
    iterations, or ``b_k_*`` after ``b_k``.  Returns ``(largest norm
    difference over its bar, largest state deviation)``."""
    n = len(log)
    if n not in (len(golden["b_seq_t"]), int(golden["b_k"])):
        raise AssertionError(f"a replay of {n} iterations: the golden holds {len(golden['b_seq_t'])} and "
                             f"a state after {int(golden['b_k'])}")
    worst = check_replay_errors(golden_records(golden, "b")[:n], log, rtol, "replay of case b")
    ref_state = _fields(golden, "b_" if n == len(golden["b_seq_t"]) else "b_k_")
    for k, v in ref_state.items():
        np.testing.assert_allclose(state[k], v, rtol=1e-10, atol=1e-16, err_msg=f"replay of case b/{k}")
    return worst, _field_deviation(state, ref_state)


def golden_records(golden, name):
    """The iteration records ``(t, dt, err, accept)`` of a case of the
    adaptive golden (``name`` ``"b"`` or a key of ``ADAPTIVE_TESTS``), as a
    list for the drivers' ``replay``."""
    p = "b_seq_" if name == "b" else f"{name}__seq_"
    return list(zip((float(x) for x in golden[p + "t"]), (float(x) for x in golden[p + "dt"]),
                    (float(x) for x in golden[p + "err"]), (bool(x) for x in golden[p + "accept"])))


def golden_state(golden, name, kind=""):
    """A case's frozen final state as ``{group: {field: array}}``: the
    driver's, or with ``kind`` ``"fine"`` its fixed-dt reference, with
    ``"replay"`` the end of the iteration loop its records come from."""
    prefix = f"{name}__{kind}__" if kind else f"{name}__"
    out = {}
    for key in golden.files:
        if key.startswith(prefix) and key.count("__") == prefix.count("__") + 1:
            group, field = key[len(prefix):].split("__")
            out.setdefault(group, {})[field] = golden[key]
    return out


def pulse_tables(n_rows, seed, ncol=FORCED_NCOL):
    """``tests/test_forcing_driver.py::_pulse_tables`` with
    ``default_rng(seed)``: a scalar wind row, per-column humidity and a warm
    pulse of theta_atm over the middle third."""
    rng = np.random.default_rng(seed)
    u = 2.0 + 1.5 * rng.random(n_rows)
    th = 296.0 + np.zeros(n_rows)
    th[n_rows // 3:n_rows // 2] = 305.0
    q = 0.004 + 0.002 * rng.random((n_rows, ncol))
    return {"u_atm": u, "theta_atm": th, "q_atm": q}


def build_batched_infiltration(dtype, device="cuda", ncol=8, nz=40):
    """``tests/test_adaptive.py::_batched_infiltration`` and ``_batched_ic``:
    sand infiltration on 8 columns of nz=40, moisture 0.10-0.12 by column."""
    import torch

    from landhydrology_tpu_torch import (
        Column, Dirichlet, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
        SoilHydrologyModel, SoilModel, SoilParams, initialize_states,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075)),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
                                         bottom=SoilComponentBC(hydrology=FreeDrainage())),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3), dtype=dtype, device=device,
    )
    v = np.full((nz, ncol), 0.1) + 0.02 * np.linspace(0.0, 1.0, ncol)[None, :]
    Y, Ya = initialize_states(model, lambda z, m: {
        "vartheta_l": torch.as_tensor(v, dtype=dtype, device=device),
        "theta_i": torch.zeros((nz, ncol), dtype=dtype, device=device)}, 0.0)
    return model, Y, Ya


def build_tiny_land(dtype, device="cuda"):
    """``tests/test_adaptive.py::_tiny_land``: a LandModel on 8 columns of
    nz=8 under a MOST atmosphere, 1e-3 m/s of rain, tau_pond 300 s, its
    exchange frozen per step."""
    import torch

    from landhydrology_tpu_torch import (
        Column, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, SoilEnergyModel, SoilHydrologyModel,
        SoilModel, SoilParams, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import (
        LandModel, PulsePrecipitation, SurfaceWaterModel, initialize_states,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    nz, ncol = 8, 8
    soil = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.0, alpha=2.0, Ksat=1e-5, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0, rho_a_sfc=1.2,
                                       q_atm=0.005),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3), dtype=dtype, device=device,
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=1e-3, t_start=0.0, t_stop=1e9), tau_pond=300.0),
        surface_update="step")

    def ic(z, m):
        th = torch.full((nz, 1), 0.2, dtype=dtype, device=device).expand(nz, ncol)
        ti = torch.zeros_like(th)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {"vartheta_l": th, "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(ti, rcs, torch.full_like(th, 290.0), ps)}

    Y, Ya = initialize_states(land, ic, 0.0)
    return land, Y, Ya


#: the JAX package's adaptive tests that run the fused engine, as the port
#: runs them: the builder, the driver's arguments and, for the tests whose
#: JAX reference is the XLA engine, ``steps_per_call=1`` (the fused run
#: equals it there); the golden keys ``<name>__*`` hold JAX's run
ADAPTIVE_TESTS = {
    "batched": dict(build="batched", tf=30.0, dt0=0.05, rtol=1e-5, atol=1e-8, steps_per_call=1),
    "segments": dict(build="batched", tf=60.0, dt0=0.02, rtol=1e-6, atol=1e-9, steps_per_call=6),
    "land7": dict(build="land", tf=30.0, dt0=2.0, rtol=1e-5, atol=1e-8, steps_per_call=1),
    "forced_fused": dict(build="forced", n_rows=8, seed=9, forcing_dt=240.0, tf=1920.0, dt0=60.0, rtol=1e-5,
                         atol=1e-10, dt_max=240.0, steps_per_call=1),
    "forced_segments": dict(build="forced", n_rows=8, seed=11, forcing_dt=240.0, tf=1920.0, dt0=30.0, rtol=1e-7,
                            atol=1e-12, dt_max=60.0, steps_per_call=4),
    "forced_trbdf2": dict(build="forced", n_rows=6, seed=13, forcing_dt=600.0, tf=3600.0, dt0=120.0, rtol=1e-6,
                          atol=1e-10, dt_max=300.0, steps_per_call=1, trbdf2="pcr"),
}


def build_adaptive_test(name, dtype, device="cuda"):
    """``(model, Y, Ya, stepper, kwargs)`` of ``ADAPTIVE_TESTS[name]``: the
    run is ``run_adaptive_fused(model, Y, Ya, 0.0, stepper=stepper,
    **kwargs)``."""
    from landhydrology_tpu_torch.adaptive import AdaptiveConfig
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import TRBDF2Soil
    from landhydrology_tpu_torch.timestepping import SSPRK33

    p = ADAPTIVE_TESTS[name]
    if p["build"] == "batched":
        model, Y, Ya = build_batched_infiltration(dtype, device)
    elif p["build"] == "land":
        model, Y, Ya = build_tiny_land(dtype, device)
    else:
        model, Y, Ya, _, _ = build_forced_model_state_and_rows(dtype, device)
    stepper = SSPRK33()
    if p.get("trbdf2"):
        stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, dtype, device), iters=2,
                             tridiag=p["trbdf2"])
    config = AdaptiveConfig(rtol=p["rtol"], atol=p["atol"], **({"dt_max": p["dt_max"]} if "dt_max" in p else {}))
    kwargs = dict(tf=p["tf"], dt0=p["dt0"], config=config, steps_per_call=p["steps_per_call"])
    if p["build"] == "forced":
        kwargs.update(forcing=pulse_tables(p["n_rows"], p["seed"]), forcing_dt=p["forcing_dt"])
    return model, Y, Ya, stepper, kwargs


#: the gradient golden (``make_golden_grad.py``, ``golden_grad_f64.npz``):
#: the loss ``mean((vartheta_l - GRAD_TARGET)^2) + mean(((rho_e_int -
#: rho_e_int0) / GRAD_SCALE)^2)`` (the second term where the state has
#: rho_e_int; ``rho_e_int0`` the start state's, a constant) of one launch of
#: ``make_fused_column_run(..., differentiable=True)`` from each case's state
#: at ``t0``, and its gradients in the start state, ``t0`` and ``dt_run``
GRAD_TARGET = 0.25
GRAD_SCALE = 1e5
GRAD_CASES = {
    # test_differentiability.py:115's column: nz=8 x 16, water only
    "column": dict(build="column", stepper="SSPRK33", steps=6, dt=20.0, t0=0.0),
    # golden #1, nz=24 x 8
    "golden1": dict(build="golden1", stepper="SSPRK33", steps=6, dt=10.0, t0=0.0),
    # the freeze golden, nz=16 x 4, under TRBDF2Soil(iters=2)
    "freeze_rate": dict(build="freeze", stepper="TRBDF2Soil", freeze="rate", lagged=False, steps=4, dt=60.0,
                        t0=0.0),
    "freeze_eq_lagged": dict(build="freeze", stepper="TRBDF2Soil", freeze="eq", lagged=True, steps=4, dt=60.0,
                             t0=0.0),
}
GRAD_FIELDS = ("vartheta_l", "theta_i", "rho_e_int")


def build_grad_column(dtype, device="cuda"):
    """``(model, Y)`` of ``test_differentiability.py:115``: a water-only
    column of nz=8 x 16 under a flux top and free drainage."""
    import torch

    from landhydrology_tpu_torch import (
        Column, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=8, batch_shape=(16,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-6, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(-1e-7)),
            bottom=SoilComponentBC(hydrology=FreeDrainage())),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3),
        dtype=dtype, device=device,
    )
    Y, _ = initialize_states(model, lambda z, m: {
        "vartheta_l": 0.2 + 0.03 * torch.sin(3.0 * z) + 0 * z, "theta_i": torch.zeros_like(z)}, 0.0)
    return model, Y


def build_grad_case(name, dtype, device="cuda"):
    """``(model, Y, stepper, case)`` of gradient case ``name``
    (:data:`GRAD_CASES`), without JAX."""
    import dataclasses

    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import TRBDF2Soil
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.timestepping import SSPRK33

    case = GRAD_CASES[name]
    if case["build"] == "column":
        model, Y = build_grad_column(dtype, device)
    elif case["build"] == "golden1":
        model, Y, _, _ = build_model_and_state(dtype, device)
    else:
        freeze = FreezeThaw(tau=60.0) if case["freeze"] == "rate" else EquilibriumFreezeThaw()
        model, Y, _, _ = build_freeze_model_and_state(dtype, device, freeze_thaw=freeze)
        model = dataclasses.replace(model, coefficient_update="step" if case["lagged"] else "stage")
    if case["stepper"] == "SSPRK33":
        stepper = SSPRK33()
    else:
        stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, dtype, device), iters=2)
    return model, Y, stepper, case


def grad_loss(fields, start):
    """The gradient golden's loss of the final ``fields`` (a dict of the
    soil's tensors or arrays, torch or JAX) from the start fields
    ``start``."""
    v = fields["vartheta_l"]
    loss = ((v - GRAD_TARGET) ** 2).mean()
    if "rho_e_int" in fields:
        loss = loss + (((fields["rho_e_int"] - start["rho_e_int"]) / GRAD_SCALE) ** 2).mean()
    return loss


def sweep_weights(Y, seed=5):
    """The gradient sweep's loss weights (``make_golden_grad.py``): for each
    field of the nested state ``Y`` of numpy arrays, standard normal draws
    of its shape over its largest magnitude (1 for an all-zero field), drawn
    in the sorted order of the groups and fields (a JAX pytree's order)."""
    rng = np.random.default_rng(seed)
    W = {}
    for g in sorted(Y):
        W[g] = {}
        for k in sorted(Y[g]):
            v = np.asarray(Y[g][k])
            W[g][k] = rng.standard_normal(v.shape) / (float(np.max(np.abs(v))) or 1.0)
    return W


#: the MOST top face's gradient golden (``make_golden_grad.py``, keys
#: ``most__<case>__``): the land golden's soil alone (MOST top, its columns
#: in one row) under a stepper, or its LandModel without the kinematic-wave routing (whose
#: Manning flux sqrt(|slope|) has no derivative at the golden's level
#: pond), ``steps`` steps of ``dt`` from t0 = 0; the loss is the sweep's
#: weighted sum of the final state (``sweep_weights``)
MOST_CASES = {
    "most_soil": dict(model="soil", stepper="SSPRK33", lagged=False, steps=4, dt=LAND_DT),
    "most_lagged": dict(model="soil", stepper="SSPRK33", lagged=True, steps=4, dt=LAND_DT),
    "most_trbdf2": dict(model="soil", stepper="TRBDF2Soil", lagged=False, steps=2, dt=60.0),
    "land": dict(model="land", stepper="SSPRK33", lagged=False, steps=4, dt=LAND_DT),
}
#: the golden's directional differences: directions per field of standard
#: normal draws times the field's largest magnitude (theta_i held: at
#: theta_i = 0 the closures switch branches), steps of MOST_FD_STEP along
#: them, and MOST_FD_DT_STEP of dt along dt (the loss moves little with
#: dt, so a smaller step would difference its rounding)
MOST_FD_DIRS, MOST_FD_STEP, MOST_FD_DT_STEP = 3, 1e-5, 1e-2


def build_most_case(name, dtype, device="cuda"):
    """``(model, Y, Ya, stepper, case)`` of MOST case ``name``
    (:data:`MOST_CASES`), without JAX: the land golden's soil alone, its
    4 x 4 columns in one row of 16 (the fused kernel's batch; without the
    routing the columns do not meet), or its LandModel without routing."""
    import dataclasses

    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.imex import TRBDF2Soil
    from landhydrology_tpu_torch.timestepping import SSPRK33

    from landhydrology_tpu_torch import Column, initialize_states

    case = MOST_CASES[name]
    land, Y, Ya, _ = build_land_model_and_state(dtype, device)
    if case["model"] == "land":
        model = dataclasses.replace(land, surface=dataclasses.replace(land.surface, runoff=None))
        return model, Y, Ya, SSPRK33(), case
    model = dataclasses.replace(
        land.soil, domain=Column(zlim=(-1.5, 0.0), nelements=LAND_NZ, batch_shape=(LAND_NX * LAND_NY,)),
        coefficient_update="step" if case["lagged"] else "stage")
    Y, Ya = initialize_states(model, lambda z, m: {k: v.reshape(LAND_NZ, -1) for k, v in Y["soil"].items()}, 0.0)
    if case["stepper"] == "SSPRK33":
        stepper = SSPRK33()
    else:
        stepper = TRBDF2Soil(model=model, grid=make_function_space(model.domain, dtype, device), iters=2)
    return model, Y, Ya, stepper, case


def most_fd_directions(golden, name):
    """The stored directions of MOST case ``name``: a list of nested dicts
    of numpy arrays."""
    prefix = f"most__{name}__dir"
    out = []
    for i in range(MOST_FD_DIRS):
        d = {}
        for key in golden.files:
            if key.startswith(f"{prefix}{i}_"):
                g, k = key[len(f"{prefix}{i}_"):].split("__")
                d.setdefault(g, {})[k] = golden[key]
        out.append(d)
    return out
