"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (every check is against the plain PyTorch version on
the card, f64 at rtol 1e-12 / atol 1e-16, f32 at the loose bars of
``_check``):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``landhydrology_tpu_torch/csrc/column_kernel.cu`` with
   nvcc, and reads the instruction cost of exp, log, sqrt and a division
   from ``cuobjdump -sass`` of small kernels (``op_costs``), for the bounds;
3. goldens in f64 through the kernel (rtol 1e-12, atol 1e-16): golden #1
   against ``golden_coupled_f64.npz`` in modes B1 and B1-no-ice, and against
   ``golden_lagged_f64.npz`` in B2 and B2-no-ice (64 steps of dt=10); the
   freeze golden against ``golden_freeze_f64.npz`` in B3-rate, and in B3-eq,
   B2+B3-rate and B2+B3-eq against the plain version (64 steps of dt=5);
   then BC/parameter variants on 1,000 columns in B1, B2, B3-rate and B3-eq;
4. the main paths at full width: ``Simulation(model, SSPRK33(),
   engine="fused")`` on the benchmark configuration (nz=64, ncol=65,536,
   steps_per_call=32, 96 steps of dt=1, saved every 32 steps) in float32 and
   float64, with stage coefficients (B1), lagged ones
   (``coefficient_update="step"``, B2), and each with ``assume_no_ice``;
   the launch counts are set to 0 just before each run and read just after;
   each is compared with the plain version and, change against change, from
   the start state (``_check_increment``); the lagged runs print their
   largest deviation from the stage run (``bench.py``'s ``max_dev_lagged``);
5. freeze-thaw at full width: the freeze golden's column at nz=64 x 65,536
   with moisture and temperature varied by column, under ``FreezeThaw(tau=60)``
   (B3-rate) and ``EquilibriumFreezeThaw()`` (B3-eq), 64 steps of dt=5 in two
   launches, f32 and f64, driven and checked as in phase 4; ice must form;
6. times of every mode's kernel and plain version at its phase-4/5 shape
   (CUDA events, in turns), beside the least time the card could take.

With ``--profile`` a seventh phase follows for B1 and B2 at the phase-4
shape: six timings each of the kernel and the plain version in turns, a
``tile_cols`` sweep, the SM clock and power draw under load, and
``Simulation.run`` end to end, unprofiled and under ``torch.profiler``
(device busy time, its share of the wall time, the kernel's share of both).

Exits non-zero on any failure, and without a result when no GPU is present.
The line before the last two is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import re
import shutil
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NZ, NCOL, N_STEPS, SPC, DT = 64, 65536, 96, 32, 1.0
FREEZE_STEPS, FREEZE_DT = 64, 5.0  # the freeze golden's run, in two launches
#: the TPU kernel every mode replaces: pl.pallas_call of _run
REPLACES = "landhydrology_tpu/ops/pallas/column_kernel.py:624"
#: H100 SXM data sheet: HBM3 bytes/s, and FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


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


def build_freeze_wide(gc, dtype, device, freeze_thaw):
    """The freeze golden's column (``golden_config_torch.build_freeze_model_and_state``)
    at the main path's width, nz=64 x 65,536, with initial water content
    0.22-0.34 and temperature 273.4-275.4 K varied by column under the
    -10 C surface."""
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    model, _, Ya, dt = gc.build_freeze_model_and_state(
        dtype, device, nz=NZ, ncol=NCOL, freeze_thaw=freeze_thaw
    )
    col = torch.arange(NCOL, dtype=dtype, device=device)[None, :] / NCOL
    theta = (0.22 + 0.12 * col).expand(NZ, NCOL).contiguous()
    theta_i = torch.zeros_like(theta)
    T = (273.4 + 2.0 * col).expand(NZ, NCOL)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, model.soil_param_set.rho_c_ds, ps)
    Y = {"soil": {
        "vartheta_l": theta, "theta_i": theta_i,
        "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous(),
    }}
    return model, Y, Ya, dt


# ---- the least time the card could take ----

#: small kernels whose SASS gives the cost of one call of each operation
_OP_SOURCE = "\n".join(
    f'extern "C" __global__ void op_{name}_{tag}(const {T}* x, const {T}* y, {T}* o) '
    f"{{ int i = threadIdx.x; o[i] = {expr}; }}"
    for tag, T, sfx in (("f32", "float", "f"), ("f64", "double", ""))
    for name, expr in (("copy", "x[i]"), ("exp", f"exp{sfx}(x[i])"), ("log", f"log{sfx}(x[i])"),
                       ("sqrt", f"sqrt{sfx}(x[i])"), ("div", "x[i] / y[i]"))
)
#: floating-point instructions of each type's own pipe in SASS
_FP_OPCODES = {
    torch.float32: {"FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK", "FRND", "MUFU"},
    torch.float64: {"DFMA", "DADD", "DMUL", "DSETP", "DMNMX"},
}
_SASS_OPCODE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def _cuobjdump(nvcc):
    for path in (os.path.join(os.path.dirname(nvcc), "cuobjdump"), shutil.which("cuobjdump")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump not found beside nvcc or on PATH")


def op_costs(ck):
    """``{dtype: {op: instructions}}``: the floating-point instructions of
    one exp, log, sqrt and division, from ``cuobjdump -sass`` of
    ``_OP_SOURCE`` built as the kernel is, counted up to the first EXIT (the
    fast path: the rare slow paths are left out) less the copy kernel's."""
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, cubin = ck.BUILD_DIR / "op_costs.cu", ck.BUILD_DIR / "op_costs.cubin"
    src.write_text(_OP_SOURCE + "\n")
    nvcc = ck._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(cubin), str(src)], check=True, capture_output=True)
    sass = subprocess.run([_cuobjdump(nvcc), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        dtype = torch.float32 if name.endswith("f32") else torch.float64
        n = 0
        for line in block.splitlines()[1:]:
            m = _SASS_OPCODE.match(line)
            if not m:
                continue
            if m.group(1) == "EXIT":
                break
            n += m.group(1) in _FP_OPCODES[dtype]
        counts[name] = n
    costs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        base = counts[f"op_copy_{tag}"]
        costs[dtype] = {op: counts[f"op_{op}_{tag}"] - base for op in ("exp", "log", "sqrt", "div")}
        # pow(x, y) is at least exp(y log x)
        costs[dtype]["pow"] = costs[dtype]["exp"] + costs[dtype]["log"]
    return costs


def registers(ck, lib):
    """``{kernel name: registers per thread}`` of each template instance,
    from the ptxas report the build keeps beside the library."""
    out, name = {}, None
    for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
        m = re.search(r"Compiling entry function '\w*ssprk33_column_kernelI([fd])Li(\d+)E", line)
        if m:
            name = f"{'f32' if m.group(1) == 'f' else 'f64'}, {ck.mode_name(int(m.group(2)))}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name], name = int(m.group(1)), None
    return out


def cell_step_ops(ck, mode, n_iter=60):
    """Operations per cell and step of one mode, counted from
    ``csrc/column_kernel.cu``: calls of exp, log, pow, sqrt and divisions by
    name, and the other floating-point operations (``op``; a multiply-add
    counts once).  Work that depends on the data is left out (the frozen
    Kersten branch, the conductivity factors, the boundary faces), so the
    count is a lower bound."""
    no_ice = bool(mode & ck.MODE_NO_ICE)
    closures = (dict(op=36, div=4, exp=4, log=4, sqrt=1) if no_ice  # closures<T, M>
                else dict(op=51, div=6, exp=5, log=4, sqrt=1))
    psi = dict(op=13, div=2, exp=2, log=2)  # pressure_head
    flux = dict(op=21, div=4)  # interior face fluxes and the stage update
    ops = collections.Counter()

    def add(n, **counts):
        for k, v in counts.items():
            ops[k] += n * v

    if mode & ck.MODE_LAGGED:  # coefficients once, then psi and T per stage
        add(1, **closures)
        add(1, op=5, div=1)  # nu_eff, theta_l, 1/rho_c_s, rho_e_int_l K
        add(3, **psi)
        add(3, **flux)
        add(3, op=4 if no_ice else 7)  # nu_eff, theta_l, T, h
    else:
        add(3, **closures)
        add(3, **psi)
        add(3, **flux)
        add(3, op=6)  # nu_eff, theta_l, rho_e_int_l K, h
    if mode & ck.MODE_FREEZE_RATE:  # phase_change_sources per stage
        add(3, op=26, div=5, pow=2)
    if mode & ck.MODE_FREEZE_EQ:  # bisection, first residual, last partition
        add(1, op=28 * n_iter + 41, div=n_iter + 2, pow=2 * n_iter + 4)
    return ops


def bound_ms(ck, costs, mode, dtype, cells, steps, n_iter=60):
    """``(ms, "bytes" or "operations")``: the larger of the state's bytes
    (three fields read and written once per launch) over HBM bandwidth and
    the floating-point instructions over the card's rate for the type (one
    fused multiply-add, two FLOPs, per lane and clock)."""
    ops = cell_step_ops(ck, mode, n_iter)
    instructions = ops["op"] + sum(ops[k] * costs[dtype][k] for k in costs[dtype])
    itemsize = torch.finfo(dtype).bits // 8
    t_bytes = 6 * itemsize * cells / HBM_BYTES_PER_S
    t_ops = cells * steps * instructions / (PEAK_FLOPS[dtype] / 2)
    return (1e3 * t_ops, "operations") if t_ops >= t_bytes else (1e3 * t_bytes, "bytes")


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


def _check_freeze(kern, plain, model, dtype, what):
    """State bars for the freeze-thaw paths at width.

    rho_e_int crosses zero at the freezing front, where its sensible and
    latent terms (~1e7 J/m3) cancel, and theta_i starts at zero, so each
    field's atol is its rtol (1e-12 in f64, 5e-4 in f32) times the field's
    largest magnitude; in f32 the water contents keep the atol 2e-4 of
    ``_check``.  With ``EquilibriumFreezeThaw`` the bisection resolves T_eq
    to adjacent floating-point numbers, and one ulp of T moves the partition
    by up to max |d theta_l,max / dT| (the steepest slope of the freezing
    curve below T_0, computed here) and rho_e_int, through the temperature
    the next stage diagnoses, by up to rho_l LH_f0 times that; both fields
    get that much more for two ulps."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import (
        EquilibriumFreezeThaw, equilibrium_unfrozen_liquid,
    )

    ps = model.earth_param_set
    rtol = {torch.float64: 1e-12, torch.float32: 5e-4}[dtype]
    water_extra = energy_extra = 0.0
    if isinstance(model.freeze_thaw, EquilibriumFreezeThaw):
        T = torch.linspace(ps.T_0 - 30.0, ps.T_0 - 1e-6, 300001, dtype=torch.float64)[:, None]
        hm = model.hydrology_model.hydraulic_model
        theta = equilibrium_unfrozen_liquid(hm, T.to(model.device), model.soil_param_set.nu, ps)
        slope = float((torch.diff(theta.double(), dim=0) / torch.diff(T.to(theta.device), dim=0)).abs().max())
        ulp = float(np.spacing(np.dtype(str(dtype)[6:]).type(ps.T_0)))
        water_extra = 2 * ulp * slope * ps.rho_cloud_liq / ps.rho_cloud_ice
        energy_extra = ps.rho_cloud_liq * ps.LH_f0 * water_extra
    for k in kern:
        scale = float(np.max(np.abs(plain[k])))
        if k == "rho_e_int":
            atol = rtol * scale + energy_extra
        else:
            atol = (rtol * scale if dtype == torch.float64 else 2e-4) + water_extra
        rel = rtol if dtype == torch.float64 or k == "rho_e_int" else 0.0
        np.testing.assert_allclose(kern[k], plain[k], rtol=rel, atol=atol, err_msg=f"{what}/{k}")
    return water_extra, energy_extra


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


def profile_main_path(dtype, device, smi, coefficient_update):
    """Phase 7 (``--profile``) at the phase-4 shape, with stage (B1) or
    lagged (B2) coefficients; prints one line per measurement and the
    profiler's table of the busiest device operations."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    points = NZ * NCOL * SPC
    model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
    model = dataclasses.replace(model, coefficient_update=coefficient_update)
    name = f"{str(dtype)[6:]} {ck.mode_name(ck.kernel_mode(model))}"
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
        print(f"[7 profile] {name} {what} ms per {SPC} steps: {[round(x, 3) for x in ms]} median "
              f"{med:.3f} -> {points / (med / 1e3):.4e} grid-points/s on {smi}", flush=True)
    for _ in range(60):  # about a second of queued launches: read the clock under load
        run(Yk, 0.0)
    load = _smi("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    print(f"[7 profile] {name} under load: SM clock, power draw, temperature = {load}", flush=True)
    for tile in (32, 64, 128, 256):
        r = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC, tile_cols=tile)
        r(Yk, 0.0)
        print(f"[7 profile] {name} tile_cols={tile}: {_time_ms(lambda: r(Yk, 0.0), 5):.3f} ms "
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
    print(f"[7 profile] {name} Simulation.run ({N_STEPS} steps, saved every {SPC}) wall ms "
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
    print(f"[7 profile] {name} profiled Simulation.run wall {wall:.3f} ms; {len(on_device)} device "
          f"operations busy {busy:.3f} ms (union) over {first_to_last:.3f} ms from first to last, "
          f"busy share of wall {busy / wall:.4f}; kernel {kernel:.3f} ms = {kernel / wall:.4f} of "
          f"wall, {kernel / busy:.4f} of busy time", flush=True)
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    print(events.table(sort_by=key, row_limit=8), flush=True)


def drive_path(ck, model, Y0, Ya, dt, n_steps, spc, what, moving):
    """One main path: ``Simulation(model, SSPRK33(), engine="fused")`` for
    ``n_steps`` steps saved every ``spc``, with the launch counts set to 0
    just before the run and read just after, held against the plain version
    (``_check``, or ``_check_freeze`` with freeze-thaw, and
    ``_check_increment``).  Returns the kernel's final state, its launch
    count and its largest deviation from the plain version."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.timestepping import SSPRK33

    dtype = model.float_dtype
    name = ck.mode_name(ck.kernel_mode(model))
    sim = Simulation(
        model, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=dt, tspan=(0.0, n_steps * dt),
        saveat=spc * dt, engine="fused", steps_per_call=spc,
    )
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    sol = sim.run()
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    if launches != {name: n_steps // spc}:
        raise AssertionError(f"{what}: expected {n_steps // spc} launches of {name}, counted {launches}")
    saves = n_steps // spc + 1
    if sol.ts.tolist() != [i * spc * dt for i in range(saves)]:
        raise AssertionError(f"{what}: saved times {sol.ts.tolist()}")
    for k, v in sol.us["soil"].items():
        if tuple(v.shape) != (saves, *Y0["soil"][k].shape) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: saved {k} has shape {tuple(v.shape)} or non-finite values")
    Yp, t = Y0, torch.as_tensor(0.0, dtype=dtype)
    for _ in range(n_steps // spc):
        Yp = ck.fused_column_run_plain(model, SSPRK33(), dt, spc, Yp, t)
        t = t + spc * torch.as_tensor(dt, dtype=dtype)
    torch.cuda.synchronize()
    kern, plain = _np(sim.Y), _np(Yp)
    extra = ""
    if model.freeze_thaw is None:
        _check(kern, plain, dtype, what)
    else:
        water, energy = _check_freeze(kern, plain, model, dtype, what)
        extra = f" (freeze bars: partition +{water:.3e}, rho_e_int +{energy:.3e})" if water else ""
    shares = _check_increment(kern, plain, _np(Y0), dtype, what, moving)
    err = _max_abs(kern, plain)
    print(f"[{what}] {str(dtype)[6:]} {name} Simulation(engine='fused') {tuple(Y0['soil']['vartheta_l'].shape)} "
          f"{n_steps} steps: {launches[name]} launches, finite, kernel vs plain max abs {err:.3e} "
          f"(vartheta_l {np.max(np.abs(kern['vartheta_l'] - plain['vartheta_l'])):.3e}); change error / "
          f"largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g}){extra}", flush=True)
    return kern, launches[name], err


def time_mode(ck, model, Y0, dt, spc):
    """``(kernel ms, plain ms)`` per launch of ``spc`` steps: CUDA events,
    in turns (plain, kernel x5, kernel x5, plain), each pair averaged."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=spc)
    Yk = _clone(Y0)
    run(Yk, 0.0)  # warm-up
    fused_column = lambda: run(Yk, 0.0)  # noqa: E731
    plain_column = lambda: ck.fused_column_run_plain(model, SSPRK33(), dt, spc, Y0, 0.0)  # noqa: E731
    plain_column()
    p1 = _time_ms(plain_column, 1)
    k1 = _time_ms(fused_column, 5)
    k2 = _time_ms(fused_column, 5)
    p2 = _time_ms(plain_column, 1)
    return (k1, k2), (p1, p2)


def check_golden(ck, model, Y, dt, n_steps, golden, what):
    """f64 through the kernel in one launch against a golden (or, with
    ``golden=None``, against the plain version alone), rtol 1e-12."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    plain = _np(ck.fused_column_run_plain(model, SSPRK33(), dt, n_steps, Y, 0.0))
    ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=n_steps)(Y, 0.0)
    torch.cuda.synchronize()
    kern = _np(Y)
    name = ck.mode_name(ck.kernel_mode(model))
    line = f"[3 golden] f64 {name} {what}:"
    if golden is not None:
        for k in kern:
            np.testing.assert_allclose(kern[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=f"{what}/{k}")
        rel = max(float(np.max(np.abs(kern[k] - golden[k]) / (np.abs(golden[k]) + 1e-300))) for k in kern)
        line += f" kernel vs golden max rel {rel:.3e} (bar 1e-12);"
    _check(kern, plain, torch.float64, f"{what} plain")
    print(f"{line} vs plain max abs {_max_abs(kern, plain):.3e}", flush=True)
    return kern


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 7: repeated timings, tile sweep, clock, profiler")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi("name,power.limit")
    device = torch.device("cuda", 0)
    print(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    lib = ck.build_library()
    ck.load_library()
    build_s = time.perf_counter() - t
    costs = op_costs(ck)
    print(f"[2 build] {ck.SOURCE.name} -> sm_90a in {build_s:.3f} s; registers per thread "
          f"(ptxas): {registers(ck, lib)}; FP instructions per call "
          f"(cuobjdump -sass, fast path): " + "; ".join(
              f"{str(d)[6:]} " + ", ".join(f"{k} {v}" for k, v in c.items()) for d, c in costs.items()),
          flush=True)

    # ---- 3: goldens in f64 through the kernel, and variants ----
    gc = _load_golden_config()
    data = os.path.join(HERE, "tests", "data")
    golden = {name: np.load(os.path.join(data, f"golden_{name}_f64.npz"))
              for name in ("coupled", "lagged", "freeze")}
    for kw, ref in (({}, "coupled"), ({"assume_no_ice": True}, "coupled"),
                    ({"coefficient_update": "step"}, "lagged"),
                    ({"coefficient_update": "step", "assume_no_ice": True}, "lagged")):
        model, Y, _, dt = gc.build_model_and_state(torch.float64, device)
        check_golden(ck, dataclasses.replace(model, **kw), Y, dt, gc.N_STEPS, golden[ref],
                     f"golden #1 vs golden_{ref}_f64.npz")
    model, Y, _, dt = gc.build_freeze_model_and_state(torch.float64, device)
    kern = check_golden(ck, model, Y, dt, gc.FREEZE_STEPS, golden["freeze"],
                        "freeze golden vs golden_freeze_f64.npz")
    if not float(np.max(kern["theta_i"])) > 1e-4:
        raise AssertionError("freeze golden: no ice formed in the kernel run")
    for freeze, lagged in ((EquilibriumFreezeThaw(), "stage"), (FreezeThaw(tau=60.0), "step"),
                           (EquilibriumFreezeThaw(), "step")):
        model, Y, _, dt = gc.build_freeze_model_and_state(torch.float64, device, freeze_thaw=freeze)
        check_golden(ck, dataclasses.replace(model, coefficient_update=lagged), Y, dt,
                     gc.FREEZE_STEPS, None, f"freeze golden's column, {type(freeze).__name__}")
    variants = ({}, {"coefficient_update": "step"}, {"freeze_thaw": FreezeThaw(tau=60.0)},
                {"freeze_thaw": EquilibriumFreezeThaw()})
    for dtype in (torch.float64, torch.float32):
        for kw in variants:
            model, Y = build_variant_model(1000, dtype, device, seed=7)
            model = dataclasses.replace(model, **kw)
            start = _np(Y)
            plain = _np(ck.fused_column_run_plain(model, SSPRK33(), 5.0, 8, Y, 2.0))
            ck.make_fused_column_run(model, SSPRK33(), dt=5.0, steps_per_call=8)(Y, 2.0)
            torch.cuda.synchronize()
            kern = _np(Y)
            what = f"variant {dtype} {ck.mode_name(ck.kernel_mode(model))}"
            _check(kern, plain, dtype, what)
            shares = _check_increment(kern, plain, start, dtype, what, ("vartheta_l", "rho_e_int"))
            print(f"[3 variant] {str(dtype)[6:]} {ck.mode_name(ck.kernel_mode(model))} ncol=1000 "
                  f"Dirichlet/flux/callable BCs, per-column params, viscosity+impedance, ice: kernel vs "
                  f"plain max abs {_max_abs(kern, plain):.3e}; change error / largest change "
                  f"{_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})", flush=True)

    # ---- 4 and 5: the main paths at full width ----
    paths = []  # (model, start state, dt, steps per launch, launches, error)
    for dtype in (torch.float32, torch.float64):
        stage_final = None
        for kw in ({}, {"assume_no_ice": True}, {"coefficient_update": "step"},
                   {"coefficient_update": "step", "assume_no_ice": True}):
            model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
            model = dataclasses.replace(model, **kw)
            kern, launches, err = drive_path(ck, model, Y0, Ya, DT, N_STEPS, SPC, "4 main",
                                             ("vartheta_l", "rho_e_int"))
            if not kw:
                stage_final = kern["vartheta_l"]
            if kw.get("coefficient_update") == "step":
                # bench.py's max_dev_lagged, held to its bar 1e-2.  In f64 the
                # deviation must also exceed 5x the change bar, so a kernel that
                # recomputed the coefficients per stage fails _check_increment;
                # in f32 the two trajectories can agree to rounding.
                dev = float(np.max(np.abs(kern["vartheta_l"] - stage_final)))
                share = dev / float(np.max(np.abs(kern["vartheta_l"] - _np(Y0)["vartheta_l"])))
                if not dev < 1e-2:
                    raise AssertionError(f"lagged run deviates from the stage run by {dev}")
                if dtype == torch.float64 and not share > 5 * INCREMENT_RTOL[dtype]:
                    raise AssertionError(f"lagged run is the stage run to {share:.3e} of the change")
                print(f"[4 main] {str(dtype)[6:]} {ck.mode_name(ck.kernel_mode(model))} max_dev_lagged "
                      f"(max |vartheta_l| deviation from the stage run) {dev:.3e} (bench.py bar 1e-2), "
                      f"{share:.3e} of the largest change", flush=True)
            paths.append((model, Y0, DT, SPC, launches, err))
        for freeze in (FreezeThaw(tau=60.0), EquilibriumFreezeThaw()):
            model, Y0, Ya, dt = build_freeze_wide(gc, dtype, device, freeze)
            kern, launches, err = drive_path(ck, model, Y0, Ya, dt, FREEZE_STEPS, FREEZE_STEPS // 2,
                                             "5 freeze", ("vartheta_l", "theta_i", "rho_e_int"))
            ice = float(np.max(kern["theta_i"]))
            if not ice > 1e-4:
                raise AssertionError(f"freeze at width: no ice formed (max theta_i {ice})")
            print(f"[5 freeze] {str(dtype)[6:]} {ck.mode_name(ck.kernel_mode(model))} max theta_i "
                  f"{ice:.4e} (> 1e-4: ice formed)", flush=True)
            paths.append((model, Y0, dt, FREEZE_STEPS // 2, launches, err))
        torch.cuda.empty_cache()

    # ---- 6: times at the main-path shapes, in turns ----
    entries = []
    for model, Y0, dt, spc, launches, err in paths:
        dtype = model.float_dtype
        mode = ck.kernel_mode(model)
        name = ck.mode_name(mode)
        (k1, k2), (p1, p2) = time_mode(ck, model, Y0, dt, spc)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        nz, ncol = Y0["soil"]["vartheta_l"].shape
        n_iter = model.freeze_thaw.n_iter if isinstance(model.freeze_thaw, EquilibriumFreezeThaw) else 60
        b_ms, b_by = bound_ms(ck, costs, mode, dtype, nz * ncol, spc, n_iter)
        points = nz * ncol * spc
        print(f"[6 time] {str(dtype)[6:]} {name} {spc} steps nz={nz} ncol={ncol}: kernel {k1:.3f}/{k2:.3f} ms "
              f"({points / (ms / 1e3):.4e} grid-points/s), plain {p1:.3f}/{p2:.3f} ms "
              f"({points / (plain_ms / 1e3):.4e} grid-points/s), bound {b_ms:.3f} ms by {b_by} "
              f"({b_ms / ms:.3f} of the kernel's time) on {smi}", flush=True)
        entries.append({
            "name": f"ssprk33_column_kernel<{str(dtype)[6:].replace('float', 'f')}, {name}>",
            "route": "cuda",
            "source": "landhydrology_tpu_torch/csrc/column_kernel.cu",
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes these steps
        })
    del paths
    torch.cuda.empty_cache()

    if args.profile:
        for coefficient_update in ("stage", "step"):
            for dtype in (torch.float32, torch.float64):
                profile_main_path(dtype, device, smi, coefficient_update)
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
