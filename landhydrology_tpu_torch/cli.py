"""Command-line entry point: run a simulation from a JSON run file.

PyTorch port of ``landhydrology_tpu/cli.py``, on the same run files::

    python -m landhydrology_tpu_torch run run.json [--device cuda|cpu]
    python -m landhydrology_tpu_torch describe run.json [--device cuda|cpu]
    python -m landhydrology_tpu_torch example [--flagship] > run.json

The ``model`` section is ``config.to_config(model)``; ``simulation`` holds
``dt``, ``t_final``, optional ``t0``, ``saveat``, ``stepper``
(ForwardEuler, SSPRK22, SSPRK33, SSPRK104, or the implicit
BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil with ``iters`` and
``tridiag``), ``engine`` (the JAX package's names: ``"xla"`` runs on this
package's eager engine ``"torch"``, ``"pallas"`` on the CUDA kernels,
``"fused"``), ``steps_per_call``, ``tile_cols`` and
``adaptive`` (an ``AdaptiveConfig``); ``initial_conditions`` has ``kind``
``default``, ``constant`` or ``hydrostatic`` (and ``h_s0`` for a
LandModel's pond); ``output.path`` names the ``.npz`` of the saved states
(keys ``t``, the soil's fields, ``surface/h_s``); ``checkpoint.directory``
a :class:`~landhydrology_tpu_torch.checkpoint.CheckpointManager` directory:
a run resumes from its latest checkpoint and writes one at its end.

The run goes on the card unless ``--device cpu`` is given; without a card
it exits with a message.  Unlike the JAX package, a resumed run keeps the
run file's engine, ``steps_per_call`` and ``tile_cols`` (the JAX CLI
resumes on XLA); both engines compute the same steps.  With the fused
engine, ``run`` prints the kernel launches of the run per mode.  The JAX
package's persistent XLA compilation cache has no counterpart here: the
CUDA kernels are built once per source content into the package's
``_build/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

import numpy as np
import torch

from landhydrology_tpu_torch import timestepping

STEPPERS = {
    "ForwardEuler": timestepping.ForwardEuler,
    "SSPRK22": timestepping.SSPRK22,
    "SSPRK33": timestepping.SSPRK33,
    "SSPRK104": timestepping.SSPRK104,
}

IMPLICIT_STEPPERS = ("BackwardEulerRichards", "BackwardEulerSoil", "TRBDF2Soil")

#: the run file's engine names (the JAX package's) and this package's engine for each
ENGINES = {"xla": "torch", "pallas": "fused"}


def _build_stepper(name: str, model=None, iters=None, tridiag=None):
    if name in STEPPERS:
        return STEPPERS[name]()
    if name in IMPLICIT_STEPPERS:
        from landhydrology_tpu_torch import imex
        from landhydrology_tpu_torch.domains import make_function_space

        soil = getattr(model, "soil", model)
        if soil is None or not hasattr(soil, "domain"):
            raise TypeError(
                f"{name} is an implicit soil stepper and needs the model "
                "(tridiagonal assembly closes over the grid)"
            )
        kwargs = {"model": soil, "grid": make_function_space(soil.domain, soil.float_dtype, soil.device)}
        if iters is not None:
            kwargs["iters"] = int(iters)
        if tridiag is not None:
            kwargs["tridiag"] = str(tridiag)
        return getattr(imex, name)(**kwargs)
    raise KeyError(
        f"unknown stepper {name!r}; available: "
        f"{sorted(STEPPERS) + sorted(IMPLICIT_STEPPERS)}"
    )


def _build_ic(model, spec: dict):
    from landhydrology_tpu_torch.models.soil.initial_conditions import initialize_states

    if hasattr(model, "soil") and hasattr(model, "surface"):
        # the soil spec applies to the soil; the pond starts at h_s0 (m, default dry)
        from landhydrology_tpu_torch.models.land import initialize_states as land_init

        soil_spec = dict(spec)
        h_s0 = float(soil_spec.pop("h_s0", 0.0))
        if soil_spec.get("kind", "default") == "default":
            raise KeyError(
                "LandModel configs need an explicit initial_conditions kind "
                "('constant' or 'hydrostatic') plus optional h_s0 — the "
                "soil default-IC shortcut does not cover the pond"
            )
        return land_init(model, _soil_ic_fn(model.soil, soil_spec), soil_spec.get("t0", 0.0), h_s0=h_s0)
    if spec.get("kind", "default") == "default":
        return model.default_initial_conditions()
    return initialize_states(model, _soil_ic_fn(model, spec), spec.get("t0", 0.0))


def _soil_ic_fn(model, spec: dict):
    """The ``(z, model) -> state dict`` IC closure of the declarative kinds."""
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity,
        volumetric_internal_energy,
    )
    from landhydrology_tpu_torch.models.soil.model import SoilEnergyModel
    from landhydrology_tpu_torch.models.soil.water import hydrostatic_profile

    kind = spec.get("kind", "constant")
    dynamic_energy = isinstance(model.energy_model, SoilEnergyModel)

    def ic(z, m):
        if kind == "constant":
            vartheta_l = torch.full_like(z, spec["vartheta_l"])
        elif kind == "hydrostatic":
            vartheta_l = hydrostatic_profile(
                m.hydrology_model.hydraulic_model, z, spec["z_table"], m.soil_param_set.nu,
                m.soil_param_set.S_s,
            )
        else:
            raise KeyError(f"unknown initial_conditions.kind {kind!r}")
        theta_i = torch.full_like(z, spec.get("theta_i", 0.0))
        out = {"vartheta_l": vartheta_l, "theta_i": theta_i}
        if dynamic_energy:
            T = torch.full_like(z, spec.get("T", 288.0))
            theta_l = torch.minimum(vartheta_l, m.soil_param_set.nu - theta_i)
            rho_c_s = volumetric_heat_capacity(theta_l, theta_i, m.soil_param_set.rho_c_ds, m.earth_param_set)
            out["rho_e_int"] = volumetric_internal_energy(theta_i, rho_c_s, T, m.earth_param_set)
        return out

    return ic


def load_run(path: str, device="cuda"):
    """Parse a run file into ``(model, stepper, Y, Ya, sim_kwargs, cfg)``,
    the model and the state on ``device``."""
    from landhydrology_tpu_torch.config import from_config

    with open(path) as f:
        cfg = json.load(f)
    model = from_config(cfg["model"], device=device)
    sim = cfg.get("simulation", {})
    stepper = _build_stepper(sim.get("stepper", "SSPRK33"), model, sim.get("iters"), sim.get("tridiag"))
    Y, Ya = _build_ic(model, cfg.get("initial_conditions", {"kind": "default"}))
    sim_kwargs = dict(
        dt=float(sim["dt"]),
        tspan=(float(sim.get("t0", 0.0)), float(sim["t_final"])),
        saveat=float(sim["saveat"]) if "saveat" in sim else None,
    )
    if "engine" in sim:
        if sim["engine"] not in ENGINES:
            raise KeyError(f"unknown engine {sim['engine']!r}; available: {sorted(ENGINES)}")
        sim_kwargs["engine"] = ENGINES[sim["engine"]]
        if "steps_per_call" in sim:
            sim_kwargs["steps_per_call"] = int(sim["steps_per_call"])
        if "tile_cols" in sim:
            sim_kwargs["tile_cols"] = int(sim["tile_cols"])
    return model, stepper, Y, Ya, sim_kwargs, cfg


def _save_states(path: str, ts, states: list) -> dict:
    """``np.savez`` of the times and each field stacked over ``states``,
    under the JAX CLI's keys (``vartheta_l``, ``surface/h_s``)."""
    arrays = {"t": np.asarray(ts)}
    for group, fields in states[-1].items():
        for k in fields:
            key = k if group == "soil" else f"{group}/{k}"
            arrays[key] = np.stack([s[group][k].detach().cpu().numpy() for s in states])
    np.savez(path, **arrays)
    return arrays


def cmd_run(path: str, device="cuda") -> int:
    from landhydrology_tpu_torch.simulations import Simulation

    model, stepper, Y, Ya, sim_kwargs, cfg = load_run(path, device)
    adaptive_cfg = cfg.get("simulation", {}).get("adaptive")
    if adaptive_cfg:
        return _run_adaptive_cfg(model, stepper, Y, Ya, sim_kwargs, cfg, adaptive_cfg)

    ckpt_cfg = cfg.get("checkpoint")
    manager = None
    run_kwargs = dict(sim_kwargs)
    if ckpt_cfg:
        from landhydrology_tpu_torch.checkpoint import CheckpointManager

        manager = CheckpointManager(ckpt_cfg["directory"])
        latest = manager.latest()
        if latest is not None:
            Y, t_res, _ = manager.restore(Y, latest)
            run_kwargs["tspan"] = (float(t_res), sim_kwargs["tspan"][1])
            print(f"resumed from checkpoint step {latest} (t={t_res})")
    sim = Simulation(model, stepper, Y_init=Y, Ya_init=Ya, **run_kwargs)

    fused = sim.engine == "fused"
    if fused:
        from landhydrology_tpu_torch.ops.cuda import column_kernel

        before = dict(column_kernel.LAUNCHES)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t_wall = time.perf_counter()
    sol = sim.run()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_wall

    out_path = cfg.get("output", {}).get("path", "trajectory.npz")
    arrays = _save_states(out_path, sol.ts.cpu(), [sol.state(i) for i in range(len(sol))])
    if manager is not None:
        nsteps = int(round((sim_kwargs["tspan"][1] - sim_kwargs["tspan"][0]) / sim_kwargs["dt"]))
        manager.save(nsteps, sol.state(len(sol) - 1), sim_kwargs["tspan"][1])
    print(f"wrote {out_path}: {len(sol)} saves x fields {sorted(k for k in arrays if k != 't')}")
    n_steps = int(round((run_kwargs["tspan"][1] - run_kwargs["tspan"][0]) / sim_kwargs["dt"]))
    cells = next(iter(next(iter(sim.Y.values())).values())).numel()
    print(f"{n_steps} steps of {cells} cells in {wall:.6f} s (host clock): "
          f"{n_steps * cells / max(wall, 1e-12):.4e} grid-points/s on {device}")
    if fused:
        launches = {k: v - before.get(k, 0) for k, v in column_kernel.LAUNCHES.items() if v != before.get(k, 0)}
        print(f"kernel launches: {json.dumps(launches, sort_keys=True)}")
    return 0


def _run_adaptive_cfg(model, stepper, Y, Ya, sim_kwargs, cfg, adaptive_cfg) -> int:
    """Error-controlled integration (``"simulation": {"adaptive": {...}}``)
    from t0 to t_final with the port's ``run_adaptive``; saves the start and
    the final state (the adaptive loop has no fixed save grid)."""
    from landhydrology_tpu_torch.adaptive import AdaptiveConfig, run_adaptive

    rhs = model.make_rhs()
    t0, tf = sim_kwargs["tspan"]
    acfg = AdaptiveConfig(**{k: v for k, v in adaptive_cfg.items() if not isinstance(v, dict)})
    Yf, stats = run_adaptive(rhs, Y, Ya, t0, tf, sim_kwargs["dt"], stepper=stepper, config=acfg, model=model)
    if not bool(stats["converged"]):
        raise RuntimeError(f"adaptive integration did not reach t_final={tf}: {stats}")
    out_path = cfg.get("output", {}).get("path", "trajectory.npz")
    _save_states(out_path, np.asarray([t0, tf]), [Y, Yf])
    print(
        f"wrote {out_path} (adaptive: {int(stats['n_accepted'])} accepted / "
        f"{int(stats['n_rejected'])} rejected steps, "
        f"dt_final={float(stats['dt_final']):.4g}s)"
    )
    return 0


def cmd_describe(path: str, device="cuda") -> int:
    model, stepper, Y, Ya, sim_kwargs, _ = load_run(path, device)
    n_state = sum(v.numel() for fields in Y.values() for v in fields.values())
    soil = getattr(model, "soil", model)
    print(f"model: {type(model).__name__} (name={model.name!r})")
    print(f"  energy:    {type(soil.energy_model).__name__}")
    print(f"  hydrology: {type(soil.hydrology_model).__name__}")
    print(f"  domain:    {soil.domain}")
    if hasattr(model, "surface"):
        sw = model.surface
        print(
            f"  surface:   {type(sw).__name__} "
            f"(precipitation={type(sw.precipitation).__name__}, "
            f"runoff={type(sw.runoff).__name__ if sw.runoff else None})"
        )
    print(f"stepper: {type(stepper).__name__} ({stepper.stages} stage(s))")
    print(f"tspan: {sim_kwargs['tspan']}, dt: {sim_kwargs['dt']}")
    print(f"state: {n_state} scalars in {sorted(Y)}: "
          f"{ {g: sorted(v) for g, v in Y.items()} }")
    print(f"device: {device}")
    return 0


EXAMPLE = {
    "model": None,  # filled in below
    "simulation": {"dt": 100.0, "t_final": 86400.0, "saveat": 21600.0, "stepper": "SSPRK33"},
    "initial_conditions": {"kind": "default"},
    "output": {"path": "trajectory.npz"},
}


def _example_model_config(model) -> dict:
    """``to_config`` of an example model with its dtype left to the run
    (``null``, float64), as the JAX package's examples leave it."""
    from landhydrology_tpu_torch.config import to_config

    cfg = to_config(model)
    soil = cfg["soil"] if cfg["__type__"] == "LandModel" else cfg
    soil["dtype"] = None
    return cfg


def cmd_example(flagship: bool = False) -> int:
    from landhydrology_tpu_torch import (
        Column,
        SoilColumnBC,
        SoilComponentBC,
        SoilEnergyModel,
        SoilHydrologyModel,
        SoilModel,
        SoilParams,
        VerticalFlux,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    if flagship:
        return _example_flagship()
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=32),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten()),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)),
            bottom=SoilComponentBC(energy=VerticalFlux(0.0), hydrology=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(),
        device="cpu",
    )
    cfg = dict(EXAMPLE)
    cfg["model"] = _example_model_config(model)
    json.dump(cfg, sys.stdout, indent=2)
    print()
    return 0


def _example_flagship() -> int:
    """The rain + pond + MOST + energy + runoff-routing catchment config."""
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
    from landhydrology_tpu_torch.models.land import (
        LandModel,
        PulsePrecipitation,
        RunoffRouting,
        SurfaceWaterModel,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    soil = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=24, batch_shape=(16, 16)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=3e-7, theta_r=0.05)
        ),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(
                u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0, rho_a_sfc=1.2, q_atm=0.005,
            ),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        device="cpu",
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(
            precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0, t_stop=1800.0),
            tau_pond=300.0,
            runoff=RunoffRouting(conductance=1e-3, dx=10.0),
        ),
    )
    cfg = {
        "model": _example_model_config(land),
        "simulation": {"dt": 5.0, "t_final": 3600.0, "saveat": 900.0, "stepper": "SSPRK33"},
        "initial_conditions": {"kind": "constant", "vartheta_l": 0.18, "T": 291.0, "h_s0": 0.0},
        "output": {"path": "flagship_trajectory.npz"},
    }
    json.dump(cfg, sys.stdout, indent=2)
    print()
    return 0


def main(argv: Any = None) -> int:
    p = argparse.ArgumentParser(prog="landhydrology_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "run on the card (cuda, the default) or on the CPU (cpu)"
    p_run = sub.add_parser("run", help="run a simulation from a JSON config")
    p_run.add_argument("config")
    p_run.add_argument("--device", default="cuda", help=device_help)
    p_desc = sub.add_parser("describe", help="summarize a config without running")
    p_desc.add_argument("config")
    p_desc.add_argument("--device", default="cuda", help=device_help)
    p_ex = sub.add_parser("example", help="print an example config to stdout")
    p_ex.add_argument(
        "--flagship", action="store_true",
        help="the full LandModel catchment config (rain + pond + MOST + energy + runoff routing)",
    )
    args = p.parse_args(argv)
    if args.cmd == "example":
        return cmd_example(flagship=args.flagship)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(
            f"landhydrology_tpu_torch {args.cmd}: no CUDA device (torch.cuda.is_available() is false); "
            "pass --device cpu to run on the CPU",
            file=sys.stderr,
        )
        return 2
    if args.cmd == "run":
        return cmd_run(args.config, args.device)
    return cmd_describe(args.config, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
