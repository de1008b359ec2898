"""Fused multi-step column kernels (CUDA, Hopper) and their plain version.

Replaces ``landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run``
in its SSPRK33 modes and its implicit modes: ``steps_per_call`` steps of the
soil tendency per launch, updating the state in place.  Two CUDA sources
share ``csrc/column_common.cuh``:

- ``csrc/column_kernel.cu``: SSPRK33 (kernel modes B1, B2, B3), on the
  coupled, water-only or heat-only branch;
- ``csrc/implicit_kernel.cu``: ``TRBDF2Soil``, ``BackwardEulerRichards`` and
  ``BackwardEulerSoil`` (kernel mode B4), with Thomas or PCR solves.

Each is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at first use (the two in parallel) and bound with
``ctypes``.

- One thread owns one column and sweeps its levels; the grid is
  ``ceil(ncol / tile_cols)`` blocks of ``tile_cols`` threads, with the ragged
  last block masked, so ``ncol`` need not be a multiple of the tile.
- The model and the stepper select the kernel's mode (:func:`kernel_mode`),
  a template instance of a source: the branch, the stepper, stage
  coefficients (B1) or lagged ones (``coefficient_update="step"``, B2),
  ``assume_no_ice``, freeze-thaw rate sources or the equilibrium projection
  (B3); ``tridiag="pcr"`` is read at run time.
- Per-column parameters arrive as a pointer plus a column stride (0 for a
  scalar).  Column constants the closures derive from the parameters
  (``m``, ``alpha**-n``, ``k_dry``, the Kersten exponents, ...) are
  evaluated here, by the same expressions the eager closures use.
- A CUDA kernel cannot call a Python BC value such as
  ``Dirichlet(lambda t: 0.31)`` or a prescribed profile ``T(z, t)``: each is
  evaluated on the host into a table with one row per (step, stage time),
  at the times the stepper's own ``stage_times`` gives (SSPRK33: ``t``,
  ``t + dt``, ``t + dt/2``; TR-BDF2: ``t``, ``t + g dt``, ``t + dt``;
  backward Euler: ``t + dt``) from the step times ``t0 + i*dt``, in the
  model dtype.  Profiles are ``(nz,)`` rows: a profile with per-column
  values is refused.

The plain version, :func:`fused_column_run_plain`, is the same number of
eager ``stepper.step`` calls, with the model's step policies wrapped around
the stepper as ``Simulation`` wraps them.  A run on CPU tensors uses it; a
run on CUDA tensors launches a kernel or raises.

Combinations without a kernel raise ``NotImplementedError`` naming their
ROADMAP item, on either device: ForwardEuler, SSPRK22 and SSPRK104 (B1),
lagged coefficients or ``assume_no_ice`` on the water-only and heat-only
branches, the implicit steppers with lagged coefficients, freeze-thaw or
``assume_no_ice`` (B4), MOST (B5, at BC construction), the LandModel pond
(B6), streamed forcing (B7), streamed geometry (B8) and
``differentiable=True`` (B9).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import (
    BackwardEulerRichards,
    BackwardEulerSoil,
    TRBDF2Soil,
    trbdf2_coefficients,
)
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil.boundary import (
    Dirichlet,
    FreeDrainage,
    NoBC,
    SoilComponentBC,
    VerticalFlux,
)
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    EquilibriumFreezeThaw,
    FreezeThaw,
    PhaseEquilibriumStepper,
    wrap_stepper_with_projection,
)
from landhydrology_tpu_torch.models.soil.initial_conditions import prognostic_vars
from landhydrology_tpu_torch.models.soil.lagged import (
    LaggedCoefficientStepper,
    _chain_contains,
    wrap_stepper_for_soil,
)
from landhydrology_tpu_torch.models.soil.model import (
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.models.soil.water import (
    IceImpedance,
    TemperatureDependentViscosity,
)
from landhydrology_tpu_torch.timestepping import SSPRK33, AbstractTimestepper

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
#: the header both kernel sources include
HEADER = CSRC / "column_common.cuh"
#: the kernel sources, one shared library each
SOURCES = {
    "column_kernel": CSRC / "column_kernel.cu",
    "implicit_kernel": CSRC / "implicit_kernel.cu",
}
#: each library's C entry points are ``<prefix>_f32`` and ``<prefix>_f64``
_ENTRY_PREFIX = {"column_kernel": "column_kernel_ssprk33", "implicit_kernel": "implicit_kernel"}
BUILD_DIR = _PACKAGE / "_build"
#: ``-split-compile=0`` optimizes the template instances of a source in
#: parallel on all host cores
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-split-compile=0",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per-column kernel inputs, in the order of ``enum Param`` in the header
PARAM_NAMES = (
    "nu", "S_s", "rho_c_ds", "theta_r", "Ksat", "m", "inv_m", "neg_inv_m",
    "inv_n", "alpha_pow_neg_n", "ln_kappa_sat_unfrozen", "ln_kappa_sat_frozen",
    "kappa_dry", "neg_b", "kersten_exp_unfrozen", "kersten_exp_bracket",
    "kersten_exp_frozen", "visc_gamma", "visc_T_ref", "impedance_coef",
    "kappa_sat_unfrozen", "alpha", "n", "tau", "n_m",
)
#: (face, component) of each BC slot, in the order of ``enum BCSlot``
BC_SLOTS = (
    ("bottom", "energy"), ("bottom", "hydrology"),
    ("top", "energy"), ("top", "hydrology"),
)
#: prescribed profiles, in the order of ``enum Profile``
PROFILE_NAMES = ("T", "vartheta_l", "theta_i")
_BC_KIND = {VerticalFlux: 1, Dirichlet: 2, FreeDrainage: 3}  # 0: no flux (BC_NONE)

#: bits of the kernel's mode word, as ``enum Mode`` in the header
MODE_LAGGED, MODE_FREEZE_RATE, MODE_FREEZE_EQ, MODE_NO_ICE = 1, 2, 4, 8
MODE_WATER, MODE_HEAT = 16, 32
MODE_BE_RICHARDS, MODE_BE_SOIL, MODE_TRBDF2 = 64, 128, 256
MODE_PCR = 512
MODE_IMPLICIT = MODE_BE_RICHARDS | MODE_BE_SOIL | MODE_TRBDF2
_STEPPER_BITS = {TRBDF2Soil: MODE_TRBDF2, BackwardEulerRichards: MODE_BE_RICHARDS,
                 BackwardEulerSoil: MODE_BE_SOIL}
_STEPPER_NAMES = {MODE_TRBDF2: "B4-trbdf2", MODE_BE_RICHARDS: "B4-be-richards",
                  MODE_BE_SOIL: "B4-be-soil"}

_P = len(PARAM_NAMES)
_B = len(BC_SLOTS)
_R = len(PROFILE_NAMES)


class _KernelArgs(ctypes.Structure):
    """Mirror of ``struct KernelArgs`` in the header (8-byte fields)."""

    _fields_ = [
        ("vartheta_l", ctypes.c_void_p),
        ("theta_i", ctypes.c_void_p),
        ("rho_e_int", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("zc", ctypes.c_void_p),
        ("param_ptr", ctypes.c_void_p * _P),
        ("param_stride", ctypes.c_int64 * _P),
        ("bc_ptr", ctypes.c_void_p * _B),
        ("bc_kind", ctypes.c_int64 * _B),
        ("bc_row_stride", ctypes.c_int64 * _B),
        ("bc_col_stride", ctypes.c_int64 * _B),
        ("nz", ctypes.c_int64),
        ("ncol", ctypes.c_int64),
        ("n_steps", ctypes.c_int64),
        ("viscosity", ctypes.c_int64),
        ("impedance", ctypes.c_int64),
        ("mode", ctypes.c_int64),
        ("n_iter", ctypes.c_int64),
        ("dt", ctypes.c_double),
        ("dz", ctypes.c_double),
        ("T_0", ctypes.c_double),
        ("rho_cloud_ice", ctypes.c_double),
        ("LH_f0", ctypes.c_double),
        ("rho_cp_l", ctypes.c_double),
        ("rho_cp_i", ctypes.c_double),
        ("rho_cloud_liq", ctypes.c_double),
        ("grav", ctypes.c_double),
        ("T_lo", ctypes.c_double),
        ("T_hi", ctypes.c_double),
        ("profile", ctypes.c_void_p * _R),
        ("rows_per_step", ctypes.c_int64),
        ("iters", ctypes.c_int64),
        ("half_g", ctypes.c_double),
        ("a1", ctypes.c_double),
        ("a2", ctypes.c_double),
        ("b_bdf2", ctypes.c_double),
    ]


# --------------------------------------------------------------------------
# Build and load
# --------------------------------------------------------------------------


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest() -> str:
    """Hash of every file under ``csrc/`` and the flags: a change to the
    header or to either source rebuilds both libraries."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> dict:
    """Compile each kernel source into ``_build/`` (once per content of
    ``csrc/`` and flag set), one ``nvcc`` per source, all started together;
    concurrent processes serialize on a lock file and publish each library by
    atomic rename.  ptxas's report (registers and spills of each template
    instance) is kept beside each library as ``<library>.ptxas.txt``.
    Returns ``{name: library path}``."""
    digest = _digest()
    libs = {name: BUILD_DIR / f"{name}_{digest}.so" for name in SOURCES}
    if all(lib.exists() for lib in libs.values()):
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = {}
        for name, lib in libs.items():
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (cmd, tmp, proc)
        failures = []
        for name, (cmd, tmp, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
                continue
            libs[name].with_suffix(".ptxas.txt").write_text(out)
            os.replace(tmp, libs[name])
        if failures:
            raise RuntimeError("\n".join(failures))
    return libs


_libraries: dict = {}


def load_library(name: str = "column_kernel") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; cached per process."""
    if name not in _libraries:
        path = build_library()[name]
        lib = ctypes.CDLL(str(path))
        size_fn = getattr(lib, f"{name}_args_size")
        size_fn.restype = ctypes.c_int
        size_fn.argtypes = []
        size = size_fn()
        if size != ctypes.sizeof(_KernelArgs):
            raise RuntimeError(
                f"KernelArgs is {size} bytes in {path.name} but "
                f"{ctypes.sizeof(_KernelArgs)} in Python"
            )
        for tag in ("f32", "f64"):
            fn = getattr(lib, f"{_ENTRY_PREFIX[name]}_{tag}")
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(_KernelArgs), ctypes.c_int, ctypes.c_void_p]
        _libraries[name] = lib
    return _libraries[name]


def _entry(mode: int, dtype) -> tuple:
    """``(library name, C function)`` that launches ``mode`` in ``dtype``."""
    name = "implicit_kernel" if mode & MODE_IMPLICIT else "column_kernel"
    return name, f"{_ENTRY_PREFIX[name]}_{'f32' if dtype == torch.float32 else 'f64'}"


#: launches of the column kernels by every run in this process, per mode
#: (:func:`mode_name`); a caller may clear it and read it back around a run
LAUNCHES: collections.Counter = collections.Counter()


# --------------------------------------------------------------------------
# Modes
# --------------------------------------------------------------------------


_POLICY_STEPPERS = (LaggedCoefficientStepper, PhaseEquilibriumStepper)


def _base_stepper(stepper):
    """``stepper`` without the step-policy wrappers the model implies."""
    while isinstance(stepper, _POLICY_STEPPERS):
        stepper = stepper.inner
    return stepper


def kernel_mode(model: SoilModel, stepper: AbstractTimestepper = SSPRK33()) -> int:
    """The kernel's mode word for ``model`` stepped by ``stepper``:
    ``MODE_*`` bits."""
    mode = MODE_LAGGED if model.coefficient_update == "step" else 0
    if isinstance(model.freeze_thaw, FreezeThaw):
        mode |= MODE_FREEZE_RATE
    elif isinstance(model.freeze_thaw, EquilibriumFreezeThaw):
        mode |= MODE_FREEZE_EQ
    if model.assume_no_ice:
        mode |= MODE_NO_ICE
    if not isinstance(model.energy_model, SoilEnergyModel):
        mode |= MODE_WATER
    elif not isinstance(model.hydrology_model, SoilHydrologyModel):
        mode |= MODE_HEAT
    base = _base_stepper(stepper)
    mode |= _STEPPER_BITS.get(type(base), 0)
    if mode & MODE_IMPLICIT and base.tridiag == "pcr":
        mode |= MODE_PCR
    return mode


def mode_name(mode: int) -> str:
    """The kernel table's name of a mode: ``B1`` (SSPRK33, stage
    coefficients) or ``B2`` (lagged), ``-no-ice`` for ``assume_no_ice``,
    ``B3-rate`` / ``B3-eq`` for freeze-thaw (``B2+B3-rate`` with lagged
    coefficients), ``B1-water`` / ``B1-heat`` for the water-only and
    heat-only branches; ``B4-trbdf2``, ``B4-be-richards`` and
    ``B4-be-soil`` for the implicit steppers, with ``-water`` / ``-heat``
    for the branch and ``-pcr`` for PCR solves."""
    branch = {MODE_WATER: "-water", MODE_HEAT: "-heat"}.get(mode & (MODE_WATER | MODE_HEAT), "")
    if mode & MODE_IMPLICIT:
        return _STEPPER_NAMES[mode & MODE_IMPLICIT] + branch + ("-pcr" if mode & MODE_PCR else "")
    if branch:
        return "B1" + branch
    name = "B2" if mode & MODE_LAGGED else "B1"
    if mode & MODE_NO_ICE:
        name += "-no-ice"
    freeze = {MODE_FREEZE_RATE: "B3-rate", MODE_FREEZE_EQ: "B3-eq"}.get(
        mode & (MODE_FREEZE_RATE | MODE_FREEZE_EQ)
    )
    if freeze:
        name = freeze if name == "B1" else f"{name}+{freeze}"
    return name


def scratch_fields(mode: int) -> int:
    """Scratch values per cell.  SSPRK33: the two stage states, and with
    lagged coefficients K, kappa, 1/rho_c_s, rho_e_int_l K (and rho_c_s for
    the rate sources).  Implicit: the iterate and the stage constants (three
    fields each), the sweep's F, K and C, and the solver's cp and dp
    (Thomas) or two sets of (a, c, d, b) (PCR)."""
    if mode & MODE_IMPLICIT:
        return 9 + (8 if mode & MODE_PCR else 2)
    if not mode & MODE_LAGGED:
        return 6
    return 11 if mode & MODE_FREEZE_RATE else 10


# --------------------------------------------------------------------------
# Host-side inputs
# --------------------------------------------------------------------------


def column_params(model: SoilModel) -> dict:
    """The kernel's per-column inputs, each a Python scalar or a tensor,
    computed by the expressions the eager closures evaluate inline."""
    sp = model.soil_param_set
    hydrology = model.hydrology_model
    hm = getattr(hydrology, "hydraulic_model", None)
    if hm is None:  # heat-only: the hydraulic inputs are never read
        hm = SoilHydrologyModel().hydraulic_model
    m = hm.m
    e_unf, e_bracket, e_fr = sh.kersten_exponents(sp)
    visc = getattr(hydrology, "viscosity_factor", None)
    imp = getattr(hydrology, "impedance_factor", None)
    is_visc = isinstance(visc, TemperatureDependentViscosity)
    is_imp = isinstance(imp, IceImpedance)
    ft = model.freeze_thaw
    return {
        "nu": sp.nu,
        "S_s": sp.S_s,
        "rho_c_ds": sp.rho_c_ds,
        "theta_r": hm.theta_r,
        "Ksat": hm.Ksat,
        "m": m,
        "inv_m": 1.0 / m,
        "neg_inv_m": -1.0 / m,
        "inv_n": 1.0 / hm.n,
        "alpha_pow_neg_n": hm.alpha ** (-hm.n),
        "ln_kappa_sat_unfrozen": sh._log_param(sp.kappa_sat_unfrozen),
        "ln_kappa_sat_frozen": sh._log_param(sp.kappa_sat_frozen),
        "kappa_dry": sh.k_dry(model.earth_param_set, sp),
        "neg_b": -sp.b,
        "kersten_exp_unfrozen": e_unf,
        "kersten_exp_bracket": e_bracket,
        "kersten_exp_frozen": e_fr,
        "visc_gamma": visc.gamma if is_visc else 0.0,
        "visc_T_ref": visc.T_ref if is_visc else 0.0,
        "impedance_coef": (-math.log(10.0)) * imp.omega if is_imp else 0.0,
        "kappa_sat_unfrozen": sp.kappa_sat_unfrozen,
        "alpha": hm.alpha,
        "n": hm.n,
        "tau": ft.tau if isinstance(ft, FreezeThaw) else 1.0,
        "n_m": hm.n * m,
    }


def _column_tensor(value, ncol: int, dtype, device, what: str):
    """``(tensor, column stride)`` for a scalar or ``(ncol,)`` value."""
    t = torch.as_tensor(value, dtype=dtype, device=device)
    if t.dim() == 0:
        return t.reshape(1), 0
    if t.shape != (ncol,):
        raise ValueError(
            f"{what} has shape {tuple(t.shape)}; expected a scalar or ({ncol},)"
        )
    return t.contiguous(), 1


def step_times(t0, dt, n_steps: int, dtype) -> list:
    """Step start times ``t0 + i*dt`` in ``dtype``, as the kernel and its
    plain version compute them."""
    t0_t = torch.as_tensor(t0, dtype=dtype).cpu()
    dt_t = torch.as_tensor(dt, dtype=dtype)
    return [t0_t + torch.tensor(float(i), dtype=dtype) * dt_t for i in range(n_steps)]


def table_times(stepper, t0, dt, n_steps: int, dtype) -> tuple:
    """``(times, rows per step)``: the times of every rhs evaluation of
    ``n_steps`` steps from ``t0``, row ``rows * i + s`` at stage time ``s``
    of step ``i``, by the stepper's own ``stage_times``."""
    base = _base_stepper(stepper)
    dt_t = torch.as_tensor(dt, dtype=dtype)
    per_step = [base.stage_times(t, dt_t) for t in step_times(t0, dt, n_steps, dtype)]
    return [t for row in per_step for t in row], len(per_step[0]) if per_step else 0


def bc_value_table(value, t0, dt, n_steps: int, ncol: int, dtype, device,
                   stepper: AbstractTimestepper = SSPRK33()):
    """A BC value as ``(table, row stride, column stride)``: row
    ``rows * i + s`` holds the value at stage time ``s`` of step ``i``
    (:func:`table_times`; SSPRK33: ``t, t + dt, t + dt/2``).  A constant
    has row stride 0, a per-column value column stride 1."""
    if not callable(value):
        table, col_stride = _column_tensor(value, ncol, dtype, device, "BC value")
        return table, 0, col_stride
    times, _ = table_times(stepper, t0, dt, n_steps, dtype)
    rows = [torch.as_tensor(value(t), dtype=dtype).cpu() for t in times]
    shape = torch.broadcast_shapes(*(r.shape for r in rows))
    if shape not in ((), (ncol,)):
        raise ValueError(
            f"BC value callable returned shape {tuple(shape)}; expected a "
            f"scalar or ({ncol},)"
        )
    table = torch.stack([r.expand(shape) for r in rows]).contiguous().to(device)
    return (table, 1, 0) if shape == () else (table, ncol, 1)


def _bc_of(model: SoilModel, face: str, component: str):
    return getattr(getattr(model.boundary_conditions, face), component)


def _dynamic(model: SoilModel, component: str) -> bool:
    """Whether the model steps ``component`` ("energy" or "hydrology")."""
    if component == "energy":
        return isinstance(model.energy_model, SoilEnergyModel)
    return isinstance(model.hydrology_model, SoilHydrologyModel)


def bc_tables(
    model: SoilModel, t0, dt, n_steps: int, ncol: int, device, reuse=None,
    stepper: AbstractTimestepper = SSPRK33(),
) -> list:
    """:func:`bc_value_table` of each BC slot (``None`` for free drainage,
    which has no value, and for a prescribed component's slot).  Where
    ``reuse`` is given, the tables of values that do not depend on time are
    taken from it and only the callable values are evaluated."""
    tables = []
    for j, (face, comp) in enumerate(BC_SLOTS):
        bc = _bc_of(model, face, comp)
        if isinstance(bc, (FreeDrainage, NoBC)) or not _dynamic(model, comp):
            tables.append(None)
            continue
        value = bc.flux if isinstance(bc, VerticalFlux) else bc.state_value
        if reuse is not None and not callable(value):
            tables.append(reuse[j])
        else:
            tables.append(bc_value_table(
                value, t0, dt, n_steps, ncol, model.float_dtype, device, stepper
            ))
    return tables


def profile_tables(model: SoilModel, zc, times) -> list:
    """The prescribed profiles at ``times`` as ``(len(times), nz)`` tables
    on ``zc``'s device, in the order of :data:`PROFILE_NAMES` (``None`` for
    a profile the branch does not prescribe): T for the water-only branch,
    vartheta_l and theta_i for the heat-only branch."""
    fns = [None] * _R
    if isinstance(model.energy_model, PrescribedTemperatureModel):
        fns[0] = model.energy_model.T_profile
    if isinstance(model.hydrology_model, PrescribedHydrologyModel):
        fns[1] = model.hydrology_model.vartheta_l_profile
        fns[2] = model.hydrology_model.theta_i_profile
    nz = zc.shape[0]
    tables = []
    for name, fn in zip(PROFILE_NAMES, fns):
        if fn is None:
            tables.append(None)
            continue
        rows = []
        for t in times:
            r = torch.as_tensor(fn(zc, t), dtype=model.float_dtype, device=zc.device)
            if torch.broadcast_shapes(r.shape, (nz, 1)) != (nz, 1):
                raise NotImplementedError(
                    f"the {name} profile returned shape {tuple(r.shape)}: per-column "
                    "prescribed profiles are not ported to the kernel yet (ROADMAP B8)"
                )
            rows.append(r.expand(nz, 1).reshape(nz))
        tables.append(torch.stack(rows).contiguous())
    return tables


# --------------------------------------------------------------------------
# Plain version and the run object
# --------------------------------------------------------------------------


def _on_grid(stepper, grid):
    """``stepper`` with its grid (the implicit steppers') replaced by ``grid``."""
    return dataclasses.replace(stepper, grid=grid) if hasattr(stepper, "grid") else stepper


def fused_column_run_plain(
    model: SoilModel, stepper: AbstractTimestepper, dt, steps_per_call: int, Y: dict, t0
) -> dict:
    """The plain PyTorch version of one kernel launch: ``steps_per_call``
    eager ``stepper.step(make_rhs(model))`` calls from ``t0``, with the
    model's step policies wrapped around ``stepper`` as ``Simulation`` wraps
    them (projection inside, lagged coefficients outside) and an implicit
    stepper's grid rebuilt on the state's device.  Returns a new state and
    leaves ``Y`` as it was."""
    dtype = model.float_dtype
    device = Y[model.name][prognostic_vars(model)[0]].device
    grid = make_function_space(model.domain, dtype, device)
    rhs = make_rhs(model, grid)
    stepper = wrap_stepper_with_projection(_on_grid(_base_stepper(stepper), grid), model)
    stepper = wrap_stepper_for_soil(stepper, model, grid)
    Ya = {"zc": grid.zc, model.name: {}}
    dt_t = torch.as_tensor(dt, dtype=dtype)
    for t in step_times(t0, dt, steps_per_call, dtype):
        Y = stepper.step(rhs, Y, Ya, t, dt_t)
    return Y


class FusedColumnRun:
    """``run(Y, t0) -> Y``: advance ``steps_per_call`` steps of ``stepper``
    from ``t0``, **in place**: the tensors of ``Y`` are overwritten and
    ``Y`` is returned.  CUDA tensors go through a kernel (or the call
    raises); CPU tensors through :func:`fused_column_run_plain` with the
    same stepper.  Each launch adds one to the module's ``LAUNCHES`` under
    the name of its mode."""

    def __init__(self, model: SoilModel, stepper, dt: float, steps_per_call: int, tile_cols: int):
        self.model = model
        self.stepper = _base_stepper(stepper)
        self.dt = float(dt)
        self.steps_per_call = int(steps_per_call)
        self.tile_cols = int(tile_cols)
        self.mode = kernel_mode(model, self.stepper)
        self.fields = prognostic_vars(model)
        self._device_inputs = {}  # (device, ncol) -> (params, zc, dz, BC tables)

    def __call__(self, Y: dict, t0) -> dict:
        model = self.model
        fields = [Y[model.name][k] for k in self.fields]
        device = fields[0].device
        if device.type == "cpu":
            Yn = fused_column_run_plain(
                model, self.stepper, self.dt, self.steps_per_call, Y, t0
            )
            for k, v in Y[model.name].items():
                v.copy_(Yn[model.name][k])
            return Y
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        self._check_state(fields, device)
        self._launch(fields, t0, device)
        return Y

    def _check_state(self, fields, device):
        nz = self.model.domain.nelements
        for f in fields:
            if f.device != device or f.dtype != self.model.float_dtype:
                raise ValueError(
                    f"state tensors must all be {self.model.float_dtype} on "
                    f"{device}; got {f.dtype} on {f.device}"
                )
            if f.dim() != 2 or f.shape[0] != nz or f.shape != fields[0].shape:
                raise ValueError(
                    f"state tensors must share the shape (nz={nz}, ncol); got "
                    f"{[tuple(g.shape) for g in fields]}"
                )
            if not f.is_contiguous():
                raise ValueError("state tensors must be contiguous")

    def _inputs(self, ncol: int, device):
        """``(params, zc, dz, BC tables)`` on ``device``, built once per
        column count; the tables of callable BC values and the profile
        tables are rebuilt per launch."""
        key = (str(device), ncol)
        if key not in self._device_inputs:
            model = self.model
            dtype = model.float_dtype
            values = column_params(model)
            params = [
                _column_tensor(values[n], ncol, dtype, device, f"parameter {n}")
                for n in PARAM_NAMES
            ]
            grid = make_function_space(model.domain, dtype, device)
            tables = bc_tables(
                model, 0.0, self.dt, self.steps_per_call, ncol, device, stepper=self.stepper
            )
            self._device_inputs[key] = (
                params, grid.zc.reshape(-1, 1).contiguous(), grid.dz, tables
            )
        return self._device_inputs[key]

    def _launch(self, fields, t0, device):
        model = self.model
        dtype = model.float_dtype
        nz, ncol = fields[0].shape
        params, zc, dz, constant_tables = self._inputs(ncol, device)
        tables = bc_tables(
            model, t0, self.dt, self.steps_per_call, ncol, device, reuse=constant_tables,
            stepper=self.stepper,
        )
        times, _ = table_times(self.stepper, t0, self.dt, self.steps_per_call, dtype)
        profiles = profile_tables(model, zc, times)
        scratch = torch.empty(scratch_fields(self.mode) * nz * ncol, dtype=dtype, device=device)
        args = kernel_args(
            model, fields, scratch, zc, dz, params, tables, self.steps_per_call, self.dt,
            stepper=self.stepper, profiles=profiles,
        )
        lib_name, fn_name = _entry(self.mode, dtype)
        lib = load_library(lib_name)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, fn_name)(
                ctypes.byref(args), self.tile_cols, ctypes.c_void_p(stream)
            )
        if rc != 0:
            raise RuntimeError(f"column kernel launch failed: cudaError {rc}")
        LAUNCHES[mode_name(self.mode)] += 1


def kernel_args(model, fields, scratch, zc, dz, params, tables, n_steps, dt,
                stepper: AbstractTimestepper = SSPRK33(), profiles=None) -> _KernelArgs:
    """Pack the kernel's argument struct.  ``fields`` are the state tensors
    in the order of ``prognostic_vars(model)``.  The caller keeps every
    tensor alive until the launch has been queued."""
    nz, ncol = fields[0].shape
    ps = model.earth_param_set
    hydrology = model.hydrology_model
    state = dict(zip(prognostic_vars(model), fields))
    base = _base_stepper(stepper)
    a = _KernelArgs()
    for name in ("vartheta_l", "theta_i", "rho_e_int"):
        if name in state:
            setattr(a, name, state[name].data_ptr())
    a.scratch = scratch.data_ptr()
    a.zc = zc.data_ptr()
    for j, (t, stride) in enumerate(params):
        a.param_ptr[j] = t.data_ptr()
        a.param_stride[j] = stride
    for j, ((face, comp), table) in enumerate(zip(BC_SLOTS, tables)):
        bc = _bc_of(model, face, comp)
        a.bc_kind[j] = _BC_KIND.get(type(bc), 0) if _dynamic(model, comp) else 0
        if table is not None:
            a.bc_ptr[j] = table[0].data_ptr()
            a.bc_row_stride[j] = table[1]
            a.bc_col_stride[j] = table[2]
    for j, table in enumerate(profiles or ()):
        if table is not None:
            a.profile[j] = table.data_ptr()
    a.nz, a.ncol, a.n_steps = nz, ncol, n_steps
    a.viscosity = int(isinstance(getattr(hydrology, "viscosity_factor", None), TemperatureDependentViscosity))
    a.impedance = int(isinstance(getattr(hydrology, "impedance_factor", None), IceImpedance))
    a.mode = kernel_mode(model, base)
    ft = model.freeze_thaw
    if isinstance(ft, EquilibriumFreezeThaw):
        a.n_iter, a.T_lo, a.T_hi = int(ft.n_iter), float(ft.T_lo), float(ft.T_hi)
    a.rows_per_step = len(base.stage_times(0.0, dt))
    a.iters = int(getattr(base, "iters", 0))
    k = trbdf2_coefficients()
    a.half_g, a.a1, a.a2, a.b_bdf2 = k["half_g"], k["a1"], k["a2"], k["b"]
    a.dt = dt
    a.dz = dz
    a.T_0 = ps.T_0
    a.rho_cloud_ice = ps.rho_cloud_ice
    a.LH_f0 = ps.LH_f0
    a.rho_cp_l = ps.rho_cp_l
    a.rho_cp_i = ps.rho_cp_i
    a.rho_cloud_liq = ps.rho_cloud_liq
    a.grav = ps.grav
    return a


# --------------------------------------------------------------------------
# Factory
# --------------------------------------------------------------------------


def _check_model(model) -> None:
    if hasattr(model, "surface"):
        raise NotImplementedError(
            "LandModel composition (kernel B6) is not ported yet: ROADMAP A12"
        )
    if not isinstance(model, SoilModel):
        raise TypeError(f"expected a SoilModel; got {type(model).__name__}")
    if not (_dynamic(model, "energy") or _dynamic(model, "hydrology")):
        raise ValueError("the fused kernel needs at least one dynamic component")
    if len(model.domain.batch_shape) != 1:
        raise ValueError(
            "the fused column kernel expects a 1-D column batch (nz, ncol); "
            f"got batch_shape={model.domain.batch_shape}"
        )
    for face, comp in BC_SLOTS:
        face_bc = getattr(model.boundary_conditions, face)
        if not isinstance(face_bc, SoilComponentBC):
            raise TypeError(f"unsupported {face} face BC {face_bc!r}")
        bc = getattr(face_bc, comp)
        if isinstance(bc, FreeDrainage) and comp == "energy":
            raise TypeError("FreeDrainage applies to the hydrology component only.")
        if not _dynamic(model, comp):
            # a prescribed component has no flux: a flux value is ignored,
            # a Dirichlet value has no state to set (boundary.py raises)
            if isinstance(bc, (Dirichlet, FreeDrainage)):
                raise TypeError(f"Unsupported BC {bc!r} for the prescribed {comp} component")
            continue
        if isinstance(bc, NoBC):
            raise ValueError(
                f"model with dynamic components requires a boundary condition "
                f"for {comp} at the {face} face (got NoBC)"
            )
        if type(bc) not in _BC_KIND:
            raise NotImplementedError(f"{type(bc).__name__} is not ported yet")


def _check_stepper(model: SoilModel, stepper) -> None:
    """Refuse a stepper, or a combination with the model, that no kernel
    runs."""
    base = _base_stepper(stepper)
    branch_only = not (_dynamic(model, "energy") and _dynamic(model, "hydrology"))
    if type(base) is SSPRK33:
        if branch_only and (model.coefficient_update == "step" or model.assume_no_ice):
            raise NotImplementedError(
                "lagged coefficients and assume_no_ice on the water-only and "
                "heat-only branches are not ported to the kernel yet (ROADMAP B1)"
            )
        # the kernel's step policies come from the model: a policy wrapper
        # the model does not call for would otherwise be dropped silently
        implied = wrap_stepper_for_soil(wrap_stepper_with_projection(base, model), model)
        st = stepper
        while isinstance(st, _POLICY_STEPPERS):
            if not _chain_contains(implied, type(st)):
                raise ValueError(
                    f"{type(st).__name__} in the stepper, but the model's "
                    "coefficient_update / freeze_thaw do not call for it"
                )
            st = st.inner
        return
    if type(base) not in _STEPPER_BITS:
        raise NotImplementedError(
            f"the fused kernels step with SSPRK33 and the implicit steppers; the "
            f"in-kernel {type(base).__name__} is not ported yet (ROADMAP B1)"
        )
    if base.model is not model:
        raise ValueError(
            f"{type(base).__name__}.model must be the run's model (the fused run "
            "steps the model it is given; build the stepper with that model)"
        )
    if base.tridiag not in ("thomas", "pcr"):
        raise ValueError(f"unknown tridiagonal solver {base.tridiag!r}")
    if isinstance(base, BackwardEulerRichards) and not _dynamic(model, "hydrology"):
        raise TypeError("BackwardEulerRichards needs a dynamic hydrology model")
    if isinstance(base, BackwardEulerSoil) and branch_only:
        raise TypeError("BackwardEulerSoil needs dynamic hydrology and energy models")
    if model.coefficient_update == "step" or model.freeze_thaw is not None or model.assume_no_ice:
        raise NotImplementedError(
            "the implicit steppers with lagged coefficients, freeze-thaw or "
            "assume_no_ice are not ported to the kernel yet (ROADMAP B4)"
        )
    if not _dynamic(model, "energy") and isinstance(
        model.hydrology_model.viscosity_factor, TemperatureDependentViscosity
    ):
        raise NotImplementedError(
            "the water-only Newton sweep with TemperatureDependentViscosity reads T "
            "from the auxiliary state, which a fused run does not carry (the JAX "
            "kernel raises KeyError there): not ported (ROADMAP B4)"
        )


def make_fused_column_run(
    model,
    stepper: AbstractTimestepper = SSPRK33(),
    dt: float = 1.0,
    steps_per_call: int = 16,
    tile_cols: int = 128,
    *,
    streamed_geometry=None,
    forcing_fields=(),
    forcing_time_grid=None,
    differentiable: bool = False,
) -> FusedColumnRun:
    """Build ``run(Y, t0) -> Y`` advancing ``steps_per_call`` steps per call
    **in place** (see :class:`FusedColumnRun`).  ``stepper`` is SSPRK33,
    bare or in the step-policy wrappers ``Simulation`` puts around it, or
    one of the implicit steppers built with this ``model``; the kernel's
    mode follows the model and the stepper (:func:`kernel_mode`).
    ``tile_cols`` is the number of columns (threads) per CUDA block, a
    multiple of 32 up to 1024; ``ncol`` need not be a multiple of it.  Time
    advances ``steps_per_call * dt`` per call."""
    _check_model(model)
    _check_stepper(model, stepper)
    if streamed_geometry is not None:
        raise NotImplementedError(
            "streamed geometry (kernel B8) is not ported yet: ROADMAP A13"
        )
    if tuple(forcing_fields) or forcing_time_grid is not None:
        raise NotImplementedError(
            "streamed forcing rows (kernel B7) are not ported yet: ROADMAP A14"
        )
    if differentiable:
        raise NotImplementedError(
            "differentiable=True (kernel B9) is not ported yet: ROADMAP A17"
        )
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1; got {steps_per_call}")
    if tile_cols < 32 or tile_cols > 1024 or tile_cols % 32:
        raise ValueError(
            f"tile_cols must be a multiple of 32 in [32, 1024]; got {tile_cols}"
        )
    return FusedColumnRun(model, stepper, dt, steps_per_call, tile_cols)
