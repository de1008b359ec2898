"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``landhydrology_tpu_torch/csrc/column_kernel.cu`` with nvcc;
3. golden #1 (f64, nz=24, ncol=8, 64 steps of dt=10) through the kernel,
   held against ``tests/data/golden_coupled_f64.npz`` (rtol 1e-12, atol 1e-16)
   and against the plain PyTorch version on the card; then BC/parameter
   variants on a ragged column count, kernel vs plain;
4. the main path at full size: ``Simulation(model, SSPRK33(), engine="fused")``
   on the benchmark configuration (nz=64, ncol=65,536, steps_per_call=32,
   96 steps of dt=1, saved every 32 steps) in float32 and float64, with the
   kernel's launch count read around the run, compared with the plain version
   (f64: rtol 1e-12; f32: atol 2e-4 on vartheta_l, relative 5e-4 on
   rho_e_int) and, change against change, from the start state (see
   ``_check_increment``);
5. times of the kernel and the plain version at that shape (CUDA events).

With ``--profile`` a sixth phase follows at the phase-4 shape: six timings
each of the kernel and the plain version in turns, a ``tile_cols`` sweep,
the SM clock and power draw under load, and ``Simulation.run`` end to end,
unprofiled and under ``torch.profiler`` (device busy time, its share of
the wall time, the kernel's share of both).

Exits non-zero on any failure, and without a result when no GPU is present.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NZ, NCOL, N_STEPS, SPC, DT = 64, 65536, 96, 32, 1.0


def _load_golden_config():
    spec = importlib.util.spec_from_file_location(
        "golden_config_torch", os.path.join(HERE, "tests", "data", "golden_config_torch.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_bench_model(nz, ncol, dtype, device):
    """The benchmark configuration of ``bench.py::build`` (coupled column,
    zero-flux top, free drainage, laterally varying moisture and
    temperature), built with the port's API."""
    from landhydrology_tpu_torch import (
        Column, FreeDrainage, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        k_solid, ksat_frozen, ksat_unfrozen, volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    nu = 0.5
    ks = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu, S_s=1e-3, nu_ss_quartz=0.92, rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=ks, kappa_sat_unfrozen=ksat_unfrozen(ks, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, nu, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=msp, dtype=dtype, device=device,
    )

    def ic(z, m):
        col = torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol
        theta = (0.25 + 0.2 * col + 0.0 * z).expand(nz, ncol)
        theta_i = torch.zeros((nz, ncol), dtype=dtype, device=device)
        T = 284.0 + 6.0 * col + 2.0 * z
        rho_c_s = volumetric_heat_capacity(theta, theta_i, msp.rho_c_ds, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya


def build_variant_model(ncol, dtype, device, seed):
    """A heterogeneous coupled column with Dirichlet, flux and callable BC
    values at both faces, temperature-dependent viscosity, ice impedance
    and some ice: the kernel paths the benchmark configuration leaves out."""
    from landhydrology_tpu_torch import (
        Column, Dirichlet, SoilColumnBC, SoilComponentBC, SoilHydrologyModel,
        SoilModel, SoilParams, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import (
        IceImpedance, TemperatureDependentViscosity, vanGenuchten,
    )
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    rng = np.random.default_rng(seed)

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    nz = 16
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=tensor(rng.uniform(1.5, 3.5, ncol)),
                alpha=tensor(rng.uniform(1.5, 4.0, ncol)),
                Ksat=tensor(rng.uniform(1e-7, 1e-5, ncol)),
                theta_r=tensor(rng.uniform(0.0, 0.05, ncol)),
            ),
            viscosity_factor=TemperatureDependentViscosity(),
            impedance_factor=IceImpedance(),
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=Dirichlet(lambda t: 0.4 + 1e-4 * t),
                energy=VerticalFlux(tensor(rng.uniform(-5.0, 5.0, ncol))),
            ),
            bottom=SoilComponentBC(
                hydrology=Dirichlet(0.38), energy=Dirichlet(lambda t: 283.0 + 0.0 * t)
            ),
        ),
        soil_param_set=SoilParams(nu=tensor(rng.uniform(0.45, 0.55, ncol)), rho_c_ds=0.963e6),
        dtype=dtype, device=device,
    )
    theta = tensor(0.3 + 0.1 * rng.random((nz, ncol)))
    theta_i = tensor(0.03 * rng.random((nz, ncol)))
    T = tensor(285.0 + 5.0 * rng.random((nz, ncol)))
    rho_c_s = volumetric_heat_capacity(theta, theta_i, 0.963e6, ps)
    Y = {"soil": {
        "vartheta_l": theta, "theta_i": theta_i,
        "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
    }}
    return model, Y


def _np(Y):
    return {k: v.detach().double().cpu().numpy() for k, v in Y["soil"].items()}


def _max_abs(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def _check(a, b, dtype, what):
    """The repo's bars: f64 rtol 1e-12 (atol 1e-16); f32 atol 2e-4 on the
    water contents and relative 5e-4 on rho_e_int."""
    if dtype == torch.float64:
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-16, err_msg=f"{what}/{k}")
    else:
        for k in ("vartheta_l", "theta_i"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-4, err_msg=f"{what}/{k}")
        rel = np.abs(a["rho_e_int"] - b["rho_e_int"]) / (np.abs(b["rho_e_int"]) + 1e3)
        if not np.max(rel) < 5e-4:
            raise AssertionError(f"{what}/rho_e_int: relative error {np.max(rel)} >= 5e-4")


#: bar on the kernel's change of a field from the start state, against the
#: plain version's change, as a share of the plain version's largest change
INCREMENT_RTOL = {torch.float64: 1e-9, torch.float32: 0.1}


def _check_increment(kern, plain, start, dtype, what, moving):
    """Hold the kernel's change from ``start`` to the plain version's.

    The state bars of ``_check`` cannot fail a kernel that changes the state
    too little: in f32 the main path's 96 steps move vartheta_l by about
    1e-4, under the 2e-4 bar.  So per field the bar is ``INCREMENT_RTOL``
    times the plain version's largest change plus eight units of rounding of
    the field's largest value, and each field in ``moving`` must change by
    at least five times its bar, so a kernel that leaves it unchanged, or
    takes a third of the steps, fails.  Returns the error over the largest
    change of each moving field."""
    eps = float(torch.finfo(dtype).eps)
    shares = {}
    for k in kern:
        dk, dp = kern[k] - start[k], plain[k] - start[k]
        scale = float(np.max(np.abs(dp)))
        bar = INCREMENT_RTOL[dtype] * scale + 8 * eps * float(np.max(np.abs(start[k])))
        err = float(np.max(np.abs(dk - dp)))
        if not err <= bar:
            raise AssertionError(f"{what}/{k}: change differs by {err:.3e} > bar {bar:.3e}")
        if k in moving:
            if not scale >= 5 * bar:
                raise AssertionError(
                    f"{what}/{k}: largest change {scale:.3e} is under 5x the bar {bar:.3e}"
                )
            shares[k] = err / scale
    return shares


def _time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fmt(shares):
    return ", ".join(f"{k} {v:.3e}" for k, v in shares.items())


def _clone(Y):
    return {"soil": {k: v.clone() for k, v in Y["soil"].items()}}


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profile_main_path(dtype, device, smi):
    """Phase 6 (``--profile``) at the phase-4 shape; prints one line per
    measurement and the profiler's table of the busiest device operations."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    name = str(dtype)[6:]
    points = NZ * NCOL * SPC
    model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC)
    Yk = _clone(Y0)
    run(Yk, 0.0)
    ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Y0, 0.0)
    kern, plain = [], []
    for _ in range(6):  # in turns, so a drift of the clock shows in both
        kern.append(_time_ms(lambda: run(Yk, 0.0), 1))
        plain.append(_time_ms(lambda: ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Y0, 0.0), 1))
    for what, ms in (("kernel", kern), ("plain", plain)):
        med = float(np.median(ms))
        print(f"[6 profile] {name} {what} ms per {SPC} steps: {[round(x, 3) for x in ms]} median "
              f"{med:.3f} -> {points / (med / 1e3):.4e} grid-points/s on {smi}", flush=True)
    for _ in range(60):  # about a second of queued launches: read the clock under load
        run(Yk, 0.0)
    load = _smi("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    print(f"[6 profile] {name} under load: SM clock, power draw, temperature = {load}", flush=True)
    for tile in (32, 64, 128, 256):
        r = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC, tile_cols=tile)
        r(Yk, 0.0)
        print(f"[6 profile] {name} tile_cols={tile}: {_time_ms(lambda: r(Yk, 0.0), 5):.3f} ms "
              f"per {SPC} steps", flush=True)

    def simulate():
        """Wall ms of one ``Simulation.run``; the simulation is built (and
        its CFL estimate made) before the clock starts."""
        sim = Simulation(
            model, SSPRK33(), Y_init=_clone(Y0), Ya_init=Ya, dt=DT, tspan=(0.0, N_STEPS * DT),
            saveat=SPC * DT, engine="fused", steps_per_call=SPC,
        )
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    simulate()
    walls = [simulate() for _ in range(3)]
    rates = [NZ * NCOL * N_STEPS / (w / 1e3) for w in walls]
    print(f"[6 profile] {name} Simulation.run ({N_STEPS} steps, saved every {SPC}) wall ms "
          f"{[round(w, 3) for w in walls]} -> {[f'{r:.4e}' for r in rates]} grid-points/s "
          f"end to end", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = simulate()
    # device-side events only (kernels and copies): the host operators' own
    # device times would count each kernel twice.  Busy time is the union of
    # their intervals, so records that overlap are counted once.
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in on_device)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy = (busy + hi - lo) / 1e3
    first_to_last = (max(e for _, e in spans) - spans[0][0]) / 1e3
    kernel = sum(e.time_range.elapsed_us() for e in on_device if "ssprk33_column_kernel" in e.name) / 1e3
    print(f"[6 profile] {name} profiled Simulation.run wall {wall:.3f} ms; {len(on_device)} device "
          f"operations busy {busy:.3f} ms (union) over {first_to_last:.3f} ms from first to last, "
          f"busy share of wall {busy / wall:.4f}; kernel {kernel:.3f} ms = {kernel / wall:.4f} of "
          f"wall, {kernel / busy:.4f} of busy time", flush=True)
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    print(events.table(sort_by=key, row_limit=8), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 6: repeated timings, tile sweep, clock, profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi("name,power.limit")
    device = torch.device("cuda", 0)
    print(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    ck.load_library()
    print(f"[2 build] {ck.SOURCE.name} -> sm_90a in {time.perf_counter() - t:.3f} s", flush=True)

    # ---- 3: golden #1 in f64 and variants, kernel vs plain ----
    gc = _load_golden_config()
    golden = np.load(os.path.join(HERE, "tests", "data", "golden_coupled_f64.npz"))
    model, Y, _, dt = gc.build_model_and_state(torch.float64, device)
    plain = _np(ck.fused_column_run_plain(model, SSPRK33(), dt, gc.N_STEPS, Y, 0.0))
    ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=gc.N_STEPS)(Y, 0.0)
    torch.cuda.synchronize()
    kern = _np(Y)
    for k in kern:
        np.testing.assert_allclose(kern[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=f"golden/{k}")
    _check(kern, plain, torch.float64, "golden plain")
    rel = max(float(np.max(np.abs(kern[k] - golden[k]) / (np.abs(golden[k]) + 1e-300))) for k in kern)
    print(f"[3 golden] f64 kernel vs golden_coupled_f64.npz max rel {rel:.3e} (bar 1e-12); "
          f"vs plain max abs {_max_abs(kern, plain):.3e}", flush=True)
    for dtype in (torch.float64, torch.float32):
        model, Y = build_variant_model(1000, dtype, device, seed=7)
        start = _np(Y)
        plain = _np(ck.fused_column_run_plain(model, SSPRK33(), 5.0, 8, Y, 2.0))
        ck.make_fused_column_run(model, SSPRK33(), dt=5.0, steps_per_call=8)(Y, 2.0)
        torch.cuda.synchronize()
        kern = _np(Y)
        _check(kern, plain, dtype, f"variant {dtype}")
        shares = _check_increment(kern, plain, start, dtype, f"variant {dtype}",
                                  ("vartheta_l", "rho_e_int"))
        print(f"[3 variant] {str(dtype)[6:]} ncol=1000 Dirichlet/flux/callable BCs, per-column "
              f"params, viscosity+impedance, ice: kernel vs plain max abs {_max_abs(kern, plain):.3e}; "
              f"change error / largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})",
              flush=True)

    # ---- 4: the main path at full size ----
    entries = []
    for dtype in (torch.float32, torch.float64):
        model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
        sim = Simulation(
            model, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=DT, tspan=(0.0, N_STEPS * DT),
            saveat=SPC * DT, engine="fused", steps_per_call=SPC,
        )
        torch.cuda.synchronize()
        ck.LAUNCHES = 0
        sol = sim.run()
        torch.cuda.synchronize()
        launches = ck.LAUNCHES
        if launches != N_STEPS // SPC:
            raise AssertionError(f"expected {N_STEPS // SPC} kernel launches, counted {launches}")
        if sol.ts.tolist() != [0.0, 32.0, 64.0, 96.0]:
            raise AssertionError(f"saved times {sol.ts.tolist()}")
        for k, v in sol.us["soil"].items():
            if tuple(v.shape) != (4, NZ, NCOL) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"saved {k}: shape {tuple(v.shape)} or non-finite values")
        Yp, t = Y0, torch.as_tensor(0.0, dtype=dtype)
        for _ in range(N_STEPS // SPC):
            Yp = ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Yp, t)
            t = t + SPC * torch.as_tensor(DT, dtype=dtype)
        torch.cuda.synchronize()
        kern, plain = _np(sim.Y), _np(Yp)
        _check(kern, plain, dtype, f"main path {dtype}")
        shares = _check_increment(kern, plain, _np(Y0), dtype, f"main path {dtype}",
                                  ("vartheta_l", "rho_e_int"))
        err = _max_abs(kern, plain)
        print(f"[4 main] {str(dtype)[6:]} Simulation(engine='fused') nz={NZ} ncol={NCOL} "
              f"{N_STEPS} steps: {launches} launches, finite, kernel vs plain max abs "
              f"{err:.3e} (vartheta_l {np.max(np.abs(kern['vartheta_l'] - plain['vartheta_l'])):.3e}); "
              f"change error / largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})",
              flush=True)

        # ---- 5: times at the main-path shape, in turns ----
        run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC)
        Yk = {"soil": {k: v.clone() for k, v in Y0["soil"].items()}}
        run(Yk, 0.0)  # warm-up
        fused_column = lambda: run(Yk, 0.0)  # noqa: E731
        plain_column = lambda: ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Y0, 0.0)  # noqa: E731
        plain_column()
        p1 = _time_ms(plain_column, 1)
        k1 = _time_ms(fused_column, 5)
        k2 = _time_ms(fused_column, 5)
        p2 = _time_ms(plain_column, 1)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        points = NZ * NCOL * SPC
        print(f"[5 time] {str(dtype)[6:]} {SPC} steps nz={NZ} ncol={NCOL}: kernel {k1:.3f}/{k2:.3f} ms "
              f"({points / (ms / 1e3):.4e} grid-points/s), plain {p1:.3f}/{p2:.3f} ms "
              f"({points / (plain_ms / 1e3):.4e} grid-points/s) on {smi}", flush=True)
        entries.append({
            "name": f"ssprk33_column_kernel<{str(dtype)[6:].replace('float', 'f')}>",
            "route": "cuda",
            "source": "landhydrology_tpu_torch/csrc/column_kernel.cu",
            "replaces": "landhydrology_tpu/ops/pallas/column_kernel.py:624",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        })
        del sim, sol, Y0, Yp, Yk
        torch.cuda.empty_cache()

    if args.profile:
        for dtype in (torch.float32, torch.float64):
            profile_main_path(dtype, device, smi)
            torch.cuda.empty_cache()

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
