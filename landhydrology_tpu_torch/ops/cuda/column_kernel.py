"""Fused multi-step column kernels (CUDA, Hopper) and their plain version.

Replaces ``landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run``
in its explicit modes, its implicit modes and its surface modes:
``steps_per_call`` steps of the soil (or land) tendency per launch, updating
the state in place.  Sixteen CUDA sources share ``csrc/column_common.cuh``:

- ``csrc/column_kernel.cu``: SSPRK33 (kernel modes B1, B2, B3), on the
  coupled, water-only or heat-only branch;
- ``csrc/tile_columns_kernel.cu``: the coupled plain soil with stage
  coefficients and per-column BC kinds and geometry (``B1+kinds+B8`` and
  ``B1-no-ice+kinds+B8``) under all four explicit steppers from the stage
  table, in the column-tile kernel of ``csrc/tile_column.cuh``: a block keeps
  a tile of columns in shared memory for the whole launch and spreads each
  column's levels over its threads (:func:`tile_plan`);
- ``csrc/implicit_kernel.cu``: ``TRBDF2Soil``, ``BackwardEulerRichards`` and
  ``BackwardEulerSoil`` (kernel mode B4), with Thomas or PCR solves, and
  under a MOST top (B4+B5) with its forcing rows;
- ``csrc/implicit_policy_kernel.cu``: the same kernel
  (``csrc/implicit_column.cuh``) with the step policies on the coupled
  plain soil (lagged coefficients, freeze-thaw, ``assume_no_ice``, lagged
  with either);
- ``csrc/implicit_most_kernel.cu``: the same kernel
  (``csrc/implicit_column.cuh``) under a MOST top with those step policies;
- ``csrc/implicit_branch_kernel.cu``: the same kernel with lagged
  coefficients, ``assume_no_ice`` or both on the water-only branch
  (TR-BDF2 and backward Euler for Richards);
- ``csrc/land_kernel.cu``: SSPRK33 with a MOST top face (kernel mode B5,
  ``PrescribedAtmosForcing``) or a ``LandModel`` pond (B6), the MOST solve
  in ``csrc/surface_fluxes.cuh``, and the LandModel on a water-only soil
  under a plain top; each with streamed forcing rows (B7): the atmosphere
  fields and the rain rate read per step from rows on the card,
  step-indexed or time-indexed;
- ``csrc/land_policy_kernel.cu``: the same kernel (``csrc/land_column.cuh``)
  under rate or equilibrium freeze-thaw or ``assume_no_ice``, each alone or
  with lagged coefficients, on the MOST soil column and the four LandModel
  tops (B5, B6, B6 with its exchange frozen per step, and both with a plain
  top BC), and under ``assume_no_ice`` on the water-only LandModel, each with
  or without forcing rows;
- ``csrc/land_rk_kernel.cu`` and ``csrc/land_policy_rk_kernel.cu``: the modes
  of the two land sources (but ``MODE_COLUMNS``) under ForwardEuler, SSPRK22
  and SSPRK104, the stepper read at run time from the launch's stage table
  (:func:`stage_table`), as in ``csrc/rk_kernel.cu``;
- ``csrc/land_columns_kernel.cu`` and ``csrc/land_policy_columns_kernel.cu``:
  the same 48 land modes with per-column BC kinds and geometry
  (``MODE_COLUMNS``) under all four explicit steppers from the stage table
  (SSPRK33 in B5 and B6 keeps ``land_kernel.cu``'s fixed stages);
- ``csrc/rk_kernel.cu``: ForwardEuler, SSPRK22 and SSPRK104 in every
  plain-soil mode of ``column_kernel.cu`` (kernel mode B1's remainder), and
  all four explicit steppers with lagged coefficients or ``assume_no_ice``
  on the water-only and heat-only branches: one template instance per
  mode, the stepper read at run time from the launch's stage table
  (:func:`stage_table`);
- ``csrc/rk_columns_kernel.cu`` and ``csrc/implicit_columns_kernel.cu``: the
  plain-soil modes with per-column BC kinds and geometry (``MODE_COLUMNS``):
  ``rk_kernel.cu``'s 16 modes but the two of ``tile_columns_kernel.cu``
  under all four explicit steppers from the stage table (SSPRK33 in B2,
  B3-rate and B1-water keeps ``column_kernel.cu``'s fixed stages), and
  ``BackwardEulerSoil`` and every
  implicit step policy on the coupled and water-only branches (TR-BDF2 and
  ``BackwardEulerRichards`` without a policy keep ``implicit_kernel.cu``'s
  instances);
- ``csrc/implicit_most_columns_kernel.cu``: the three implicit steppers under
  a MOST top with per-column BC kinds and geometry, without a step policy
  and with each (24 instances per float type), with forcing rows or without.

Each is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface at its first use (both float types in parallel;
:func:`build_library` builds any set of sources at once) and bound with
``ctypes``.

- One thread owns one column and sweeps its levels; the grid is
  ``ceil(ncol / tile_cols)`` blocks of ``tile_cols`` threads, with the ragged
  last block masked, so ``ncol`` need not be a multiple of the tile.  The
  column-tile kernel alone spreads a column's levels over threads: its blocks
  of 256 threads hold at most ``tile_cols`` columns, the tile and its level
  lanes planned from ``nz`` by :func:`tile_plan`.
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
  ``t + dt``, ``t + dt/2``; SSPRK104: ten, ``dt/6`` accumulated; TR-BDF2:
  ``t``, ``t + g dt``, ``t + dt``; backward Euler: ``t + dt``) from the
  step times ``t0 + i*dt``, in the
  model dtype.  So are callable atmosphere fields and the rain rate.
  Profiles are ``(nz,)`` rows, or ``(nz, ncol)`` rows where they vary by
  column (kernel mode B8), up to ``PROFILE_TABLE_BYTES`` per launch.
  Tables of values that do not depend on time (constants, the default
  profiles) are built once per column count; the package's declarative
  rain classes are tabulated in one vectorised call per launch.
- Per-column BC kinds (``BatchedBC``, kernel mode B1-batched) arrive as an
  int32 column of the kernel's kind codes per slot, mapped once on the host
  (:func:`cuda_kind_codes`); per-column geometry (a ``VariableDepthColumn``
  or ``streamed_geometry``, kernel mode B8) as a ``(ncol,)`` spacing and
  ``(nz, ncol)`` centers read in place.  Both are read at run time by the
  template instances with ``MODE_COLUMNS``, one beside each mode that takes
  them (:func:`takes_per_column`: every explicit mode, the land modes with
  forcing rows or without, and every implicit mode on the plain soil and
  under a MOST top but TR-BDF2 on the heat-only branch); the instances
  without it read what they read before those modes, in fewer registers.

The plain version, :func:`fused_column_run_plain`, is the same number of
eager ``stepper.step`` calls, with the model's step policies wrapped around
the stepper as ``Simulation`` wraps them, on the run's grid (per-column with
B8) and BCs.  A run on CPU tensors uses it; a
run on CUDA tensors launches a kernel or raises.

Every mode takes its step size at run time (kernel mode B1-dt):
``run(Y, t0, dt_run=h)`` launches at ``h`` rounded to the model dtype, its
tables built at the stage times of ``h``, and equals a run built with
``dt=h`` bit for bit.  The implicit steppers also run under a MOST top
(``B4-trbdf2+B5``, ``B4-be-soil+B5``, ``B4-be-richards+B5``, and with the
step policies ``B4-trbdf2+B2+B3-rate+B5``, ``B4-be-soil-no-ice+B2+B5``,
...), with its forcing rows (B7): every rhs evaluation of the implicit
kernel takes its top fluxes from a MOST solve at its own top cell, at T as
that evaluation's rhs diagnoses it.

``differentiable=True`` (kernel mode B9, ``ops/cuda/differentiable.py``)
returns a run that ``torch.autograd`` differentiates in the state, t0 and
dt_run: the forward is the kernel, the backward the plain version's vjp,
replayed one step at a time.

Combinations without a kernel raise ``NotImplementedError`` naming their
ROADMAP item, on either device: the implicit steppers with step policies
on the heat-only branch (whose heat sweep in the reference reads theta_i
from a state that holds none), the water-only Newton sweep with
``TemperatureDependentViscosity``, and the implicit steppers with a
LandModel, which the reference kernel cannot run either (B4), and
per-column kinds or geometry with TR-BDF2 on the heat-only branch (not
queued: the reference's TR-BDF2 cannot run that branch at all).
Lateral coupling, pond routing, a per-column rain callable and a 2-D column
batch raise ``ValueError``, as the JAX kernel's factory does; so does
a non-differentiable run on CUDA state tensors that require grad in grad
mode (the kernel writes them where autograd cannot see).
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
import time
from pathlib import Path

import torch

from landhydrology_tpu_torch.domains import ColumnGrid, VariableDepthColumn, make_function_space
from landhydrology_tpu_torch.models.land import (
    ConstantPrecipitation,
    FrozenExchangeStepper,
    LandModel,
    PulsePrecipitation,
    check_rain,
    make_rhs as make_land_rhs,
    wrap_stepper_for_land,
)
from landhydrology_tpu_torch.imex import (
    BackwardEulerRichards,
    BackwardEulerSoil,
    TRBDF2Soil,
    trbdf2_coefficients,
)
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil.boundary import (
    BatchedBC,
    BCKind,
    Dirichlet,
    FreeDrainage,
    NoBC,
    PrescribedAtmosForcing,
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
    _default_T_profile,
    _default_zero_profile,
)
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.models.soil.water import (
    IceImpedance,
    TemperatureDependentViscosity,
)
from landhydrology_tpu_torch.runtime.forcing_driver import (
    _install_forcing_rows,
    _row_local_step,
    _split_routing,
    time_row,
)
from landhydrology_tpu_torch.timestepping import (
    SSPRK22,
    SSPRK33,
    SSPRK104,
    AbstractTimestepper,
    ForwardEuler,
)

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
#: the header every kernel source includes
HEADER = CSRC / "column_common.cuh"
#: the kernel sources, one shared library per source and float type
SOURCES = {
    "column_kernel": CSRC / "column_kernel.cu",
    "implicit_kernel": CSRC / "implicit_kernel.cu",
    "implicit_most_kernel": CSRC / "implicit_most_kernel.cu",
    "implicit_branch_kernel": CSRC / "implicit_branch_kernel.cu",
    "land_kernel": CSRC / "land_kernel.cu",
    "land_policy_kernel": CSRC / "land_policy_kernel.cu",
    "land_rk_kernel": CSRC / "land_rk_kernel.cu",
    "land_policy_rk_kernel": CSRC / "land_policy_rk_kernel.cu",
    "land_columns_kernel": CSRC / "land_columns_kernel.cu",
    "land_policy_columns_kernel": CSRC / "land_policy_columns_kernel.cu",
    "rk_kernel": CSRC / "rk_kernel.cu",
    "implicit_policy_kernel": CSRC / "implicit_policy_kernel.cu",
    "rk_columns_kernel": CSRC / "rk_columns_kernel.cu",
    "implicit_columns_kernel": CSRC / "implicit_columns_kernel.cu",
    "implicit_most_columns_kernel": CSRC / "implicit_most_columns_kernel.cu",
    "tile_columns_kernel": CSRC / "tile_columns_kernel.cu",
}
#: a source's C entry points are ``<prefix>_f32`` and ``<prefix>_f64``; the
#: library of each float type is compiled with ``-DKERNEL_<TAG>_ONLY`` and
#: holds that type's template instances alone, so the halves build in parallel
_TAGS = ("f32", "f64")
_ENTRY_PREFIX = {"column_kernel": "column_kernel_ssprk33", "implicit_kernel": "implicit_kernel",
                 "implicit_most_kernel": "implicit_most_kernel", "implicit_branch_kernel": "implicit_branch_kernel",
                 "land_kernel": "land_kernel", "land_policy_kernel": "land_policy_kernel",
                 "land_rk_kernel": "land_rk_kernel", "land_policy_rk_kernel": "land_policy_rk_kernel",
                 "land_columns_kernel": "land_columns_kernel",
                 "land_policy_columns_kernel": "land_policy_columns_kernel", "rk_kernel": "rk_kernel",
                 "implicit_policy_kernel": "implicit_policy_kernel", "rk_columns_kernel": "rk_columns_kernel",
                 "implicit_columns_kernel": "implicit_columns_kernel",
                 "implicit_most_columns_kernel": "implicit_most_columns_kernel",
                 "tile_columns_kernel": "tile_columns_kernel"}
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
#: inputs of the surface exchange, in the order of ``enum Surface``: the
#: atmosphere's fields, the roughness lengths, the pond's parameters
SURFACE_NAMES = (
    "u_atm", "theta_atm", "z_atm", "theta_scale", "rho_a_sfc", "q_atm", "z_0m", "z_0s",
    "tau_pond", "h_evap_smoothing",
)
#: ``enum BCKind`` of the header: 0 is a prescribed component's slot (no
#: flux); a ``BatchedBC`` slot (BC_BATCHED) reads each column's kind
BC_FLUX, BC_DIRICHLET, BC_FREE_DRAINAGE, BC_BATCHED = 1, 2, 3, 4
_BC_KIND = {VerticalFlux: BC_FLUX, Dirichlet: BC_DIRICHLET, FreeDrainage: BC_FREE_DRAINAGE,
            BatchedBC: BC_BATCHED}
#: the most bytes of time-dependent per-column profile tables a launch builds
PROFILE_TABLE_BYTES = 1 << 30
#: ``KernelArgs::frow_mode`` of step-indexed and time-indexed forcing rows (0: none)
FROW_STEP, FROW_TIME = 1, 2

#: bits of the kernel's mode word, as ``enum Mode`` in the header
MODE_LAGGED, MODE_FREEZE_RATE, MODE_FREEZE_EQ, MODE_NO_ICE = 1, 2, 4, 8
MODE_WATER, MODE_HEAT = 16, 32
MODE_BE_RICHARDS, MODE_BE_SOIL, MODE_TRBDF2 = 64, 128, 256
MODE_PCR = 512
MODE_MOST, MODE_LAND, MODE_SURFACE_STEP = 1024, 2048, 4096
#: the instance reads per-column BC kinds, grid and profiles (B1-batched, B8)
MODE_COLUMNS = 8192
#: the explicit steppers of ``csrc/rk_kernel.cu`` (SSPRK33 has no bit), read
#: at run time from the launch's stage table
MODE_EULER, MODE_SSPRK22, MODE_SSPRK104 = 16384, 32768, 65536
#: set by the sources on their no-ice template instances (every instance of
#: ``csrc/rk_kernel.cu``), never in a run's mode word: no ice caps theta_l at
#: nu - theta_i in the stage rhs, as rhs.py
MODE_RHS_CAP = 131072
MODE_IMPLICIT = MODE_BE_RICHARDS | MODE_BE_SOIL | MODE_TRBDF2
MODE_RK = MODE_EULER | MODE_SSPRK22 | MODE_SSPRK104
_STEPPER_BITS = {TRBDF2Soil: MODE_TRBDF2, BackwardEulerRichards: MODE_BE_RICHARDS,
                 BackwardEulerSoil: MODE_BE_SOIL, ForwardEuler: MODE_EULER, SSPRK22: MODE_SSPRK22,
                 SSPRK104: MODE_SSPRK104}
#: the steppers the explicit kernels run
_EXPLICIT_STEPPERS = (ForwardEuler, SSPRK22, SSPRK33, SSPRK104)
_STEPPER_NAMES = {MODE_TRBDF2: "B4-trbdf2", MODE_BE_RICHARDS: "B4-be-richards",
                  MODE_BE_SOIL: "B4-be-soil", MODE_EULER: "ForwardEuler", MODE_SSPRK22: "SSPRK22",
                  MODE_SSPRK104: "SSPRK104"}
#: the policies of ``csrc/land_policy_kernel.cu`` (with or without MODE_LAGGED)
_FREEZE_OR_NO_ICE = MODE_FREEZE_RATE | MODE_FREEZE_EQ | MODE_NO_ICE
#: the modes with MODE_COLUMNS whose SSPRK33 instance has fixed stages: B2, B3-rate and B1-water
#: (``csrc/column_kernel.cu``), B5 and B6 (``csrc/land_kernel.cu``); the others, and these under the other
#: steppers, run the stage table of ``csrc/rk_columns_kernel.cu``, ``csrc/land_columns_kernel.cu`` and
#: ``csrc/land_policy_columns_kernel.cu``, but :data:`TILE_MODES`
_SSPRK33_COLUMNS = frozenset({MODE_LAGGED | MODE_COLUMNS, MODE_FREEZE_RATE | MODE_COLUMNS,
                              MODE_WATER | MODE_COLUMNS, MODE_MOST | MODE_COLUMNS,
                              MODE_LAND | MODE_MOST | MODE_COLUMNS})
#: the modes of the column-tile kernel (``csrc/tile_columns_kernel.cu``) under every explicit stepper (the
#: stepper's bits aside): the coupled plain soil with stage coefficients and MODE_COLUMNS, with ice and without
TILE_MODES = frozenset({MODE_COLUMNS, MODE_NO_ICE | MODE_COLUMNS})
#: ``enum StageKind`` of the header and its most stages per step
STAGE_AXPY, STAGE_COMB, STAGE_SPLIT, STAGE_FINAL = 0, 1, 2, 3
MAX_STAGES = 10

_P = len(PARAM_NAMES)
_B = len(BC_SLOTS)
_R = len(PROFILE_NAMES)
_S = len(SURFACE_NAMES)


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
        ("surface_ptr", ctypes.c_void_p * _S),
        ("surface_row_stride", ctypes.c_int64 * _S),
        ("surface_col_stride", ctypes.c_int64 * _S),
        ("precip", ctypes.c_void_p),
        ("h_s", ctypes.c_void_p),
        *((name, ctypes.c_double) for name in (
            "von_karman_const", "cp_d", "cp_v", "cp_l", "R_d", "R_v", "LH_v0",
            "press_triple", "T_triple", "molmass_ratio")),
        ("forced", ctypes.c_int64),
        ("frow_mode", ctypes.c_int64),
        ("n_frows", ctypes.c_int64),
        ("precip_row_stride", ctypes.c_int64),
        ("precip_col_stride", ctypes.c_int64),
        ("t0", ctypes.c_double),
        ("t_forcing0", ctypes.c_double),
        ("inv_dt_forcing", ctypes.c_double),
        ("bc_kind_col", ctypes.c_void_p * _B),
        ("bc_kind_col_stride", ctypes.c_int64 * _B),
        ("dz_col", ctypes.c_void_p),
        ("dz_col_stride", ctypes.c_int64),
        ("zc_level_stride", ctypes.c_int64),
        ("zc_col_stride", ctypes.c_int64),
        ("profile_row_stride", ctypes.c_int64 * _R),
        ("profile_level_stride", ctypes.c_int64 * _R),
        ("profile_col_stride", ctypes.c_int64 * _R),
        ("n_stages", ctypes.c_int64),
        ("stage_in", ctypes.c_int64 * MAX_STAGES),
        ("stage_out", ctypes.c_int64 * MAX_STAGES),
        ("stage_aux", ctypes.c_int64 * MAX_STAGES),
        ("stage_kind", ctypes.c_int64 * MAX_STAGES),
        ("stage_c", ctypes.c_double * (5 * MAX_STAGES)),
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
    """Hash of every file under ``csrc/`` and the flags: a change to a
    header or to any source rebuilds every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def build_library(sources=None, jobs=None) -> dict:
    """Compile the kernel sources named in ``sources`` (keys of
    :data:`SOURCES`; all by default) into ``_build/`` (once per content of
    ``csrc/`` and flag set), one ``nvcc`` per source and float type, all
    started together, or at most ``jobs`` at a time in the order of
    ``sources`` (f64 before f32); concurrent processes serialize on a lock
    file and publish each library by atomic rename.  ptxas's report
    (registers and spills of each template instance) is kept beside each
    library as ``<library>.ptxas.txt``, and each compile's seconds from the
    build's start in :data:`BUILD_SECONDS`.  Returns ``{library key:
    path}``, keyed ``<source>_<tag>``."""
    digest = _digest()
    names = SOURCES if sources is None else sources
    libs = {f"{name}_{tag}": BUILD_DIR / f"{name}_{tag}_{digest}.so" for name in names for tag in _TAGS[::-1]}
    if all(lib.exists() for lib in libs.values()):
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        started = {}
        pending = [key for key, lib in libs.items() if not lib.exists()]
        start = time.perf_counter()
        while pending or any(proc.poll() is None for _, _, proc, _ in started.values()):
            running = sum(proc.poll() is None for _, _, proc, _ in started.values())
            while pending and (jobs is None or running < jobs):
                key = pending.pop(0)
                name, tag = key.rsplit("_", 1)
                tmp = libs[key].with_name(f"{libs[key].name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, f"-DKERNEL_{tag.upper()}_ONLY", "-o", str(tmp), str(SOURCES[name])]
                report = open(tmp.with_suffix(".log"), "w+")
                proc = subprocess.Popen(cmd, stdout=report, stderr=subprocess.STDOUT, text=True)
                started[key] = (cmd, tmp, proc, report)
                running += 1
            for key, (_, _, proc, _) in started.items():
                if proc.poll() is not None and key not in BUILD_SECONDS:
                    BUILD_SECONDS[key] = time.perf_counter() - start
            time.sleep(0.1)
        failures = []
        for key, (cmd, tmp, proc, report) in started.items():
            BUILD_SECONDS.setdefault(key, time.perf_counter() - start)
            report.seek(0)
            out = report.read()
            report.close()
            os.remove(report.name)
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
                continue
            libs[key].with_suffix(".ptxas.txt").write_text(out)
            os.replace(tmp, libs[key])
        if failures:
            raise RuntimeError("\n".join(failures))
    return libs


#: seconds from the start of the build to each compile's end, per library
BUILD_SECONDS: dict = {}
_libraries: dict = {}


def load_library(key: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``key``, ``<source>_<tag>``;
    cached per process."""
    if key not in _libraries:
        name, tag = key.rsplit("_", 1)
        path = build_library((name,))[key]
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
        fn = getattr(lib, f"{_ENTRY_PREFIX[name]}_{tag}")
        fn.restype = ctypes.c_int
        # the column-tile kernel takes its tile plan (columns, lanes, shared bytes), the others their block
        ints = [ctypes.c_int] * (3 if name == "tile_columns_kernel" else 1)
        fn.argtypes = [ctypes.POINTER(_KernelArgs), *ints, ctypes.c_void_p]
        _libraries[key] = lib
    return _libraries[key]


def _entry(mode: int, dtype) -> tuple:
    """``(library name, C function)`` that launches ``mode`` in ``dtype``."""
    table_columns = mode & MODE_COLUMNS and (mode & MODE_RK or mode not in _SSPRK33_COLUMNS)
    if mode & ~MODE_RK in TILE_MODES:
        name = "tile_columns_kernel"  # every explicit stepper from the stage table
    elif mode & MODE_IMPLICIT:
        policy = mode & _POLICY_BITS
        if mode & MODE_COLUMNS and mode & MODE_MOST:
            name = "implicit_most_columns_kernel"
        elif mode & MODE_COLUMNS and (policy or mode & MODE_BE_SOIL):
            name = "implicit_columns_kernel"
        elif policy:
            name = ("implicit_branch_kernel" if mode & MODE_WATER
                    else "implicit_most_kernel" if mode & MODE_MOST else "implicit_policy_kernel")
        else:
            name = "implicit_kernel"
    elif mode & (MODE_MOST | MODE_LAND):
        name = "land_policy" if mode & _FREEZE_OR_NO_ICE else "land"
        if table_columns:
            name += "_columns_kernel"  # every stepper from the stage table
        else:
            name += "_rk_kernel" if mode & MODE_RK else "_kernel"
    elif table_columns:
        name = "rk_columns_kernel"  # every stepper from the stage table
    elif mode & MODE_RK or (mode & (MODE_WATER | MODE_HEAT) and mode & (MODE_LAGGED | MODE_NO_ICE)):
        name = "rk_kernel"
    else:
        name = "column_kernel"
    return name, f"{_ENTRY_PREFIX[name]}_{'f32' if dtype == torch.float32 else 'f64'}"


#: launches of the column kernels by every run in this process, per mode
#: (:func:`mode_name`); a caller may clear it and read it back around a run
LAUNCHES: collections.Counter = collections.Counter()


# --------------------------------------------------------------------------
# Modes
# --------------------------------------------------------------------------


_POLICY_STEPPERS = (LaggedCoefficientStepper, PhaseEquilibriumStepper, FrozenExchangeStepper)


def _base_stepper(stepper):
    """``stepper`` without the step-policy wrappers the model implies."""
    while isinstance(stepper, _POLICY_STEPPERS):
        stepper = stepper.inner
    return stepper


def _soil_of(model) -> SoilModel:
    """The soil column of a ``SoilModel`` or a ``LandModel``."""
    return model.soil if isinstance(model, LandModel) else model


def kernel_mode(model, stepper: AbstractTimestepper = SSPRK33(), streamed_geometry=None) -> int:
    """The kernel's mode word for ``model`` (a ``SoilModel`` or a
    ``LandModel``) stepped by ``stepper``: ``MODE_*`` bits, with
    ``MODE_COLUMNS`` where the run reads per-column kinds or geometry
    (:func:`per_column_features`)."""
    mode = MODE_COLUMNS if any(per_column_features(model, streamed_geometry)) else 0
    if isinstance(model, LandModel):
        mode |= MODE_LAND | (MODE_SURFACE_STEP if model.surface_update == "step" else 0)
        model = model.soil
    if isinstance(model.boundary_conditions.top, PrescribedAtmosForcing):
        mode |= MODE_MOST
    if model.coefficient_update == "step":
        mode |= MODE_LAGGED
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


def mode_name(mode: int, features: tuple = (True, True)) -> str:
    """The kernel table's name of a mode: ``B1`` (SSPRK33, stage
    coefficients) or ``B2`` (lagged), ``-no-ice`` for ``assume_no_ice``,
    ``B3-rate`` / ``B3-eq`` for freeze-thaw (``B2+B3-rate`` with lagged
    coefficients), ``B1-water`` / ``B1-heat`` for the water-only and
    heat-only branches (``B2-water``, ``B1-heat-no-ice``, ... with lagged
    coefficients or ``assume_no_ice``); ``@ForwardEuler``, ``@SSPRK22`` or
    ``@SSPRK104`` after any of these for the other explicit steppers
    (``B3-eq@SSPRK104``); ``B4-trbdf2``, ``B4-be-richards`` and
    ``B4-be-soil`` for the implicit steppers, with ``-water`` / ``-heat``
    for the branch, ``-no-ice``, ``-pcr`` for PCR solves, ``+B2`` for
    lagged coefficients, ``+B3-rate`` / ``+B3-eq`` for freeze-thaw and
    ``+B5`` under a MOST top (``B4-trbdf2-pcr+B2+B3-eq``,
    ``B4-trbdf2-pcr+B5``, ``B4-be-richards-water-no-ice+B2``); ``B5`` for a MOST top
    (``B2+B5`` lagged), ``B6`` for the LandModel with a MOST top, ``-step``
    with its exchange frozen per step, ``B2+`` lagged and ``-pond`` with a
    plain top BC (``B2+B6-step-pond``), ``-water`` on a water-only soil
    (``B6-pond-water``), each with ``+B3-rate``, ``+B3-eq`` or ``-no-ice``
    for its step policy (``B6+B3-rate``, ``B2+B6-step+B3-eq``,
    ``B5-no-ice``, ``B2+B6-pond-no-ice``, ``B2+B6-step-pond-water-no-ice``),
    each with ``@ForwardEuler``, ... for the other explicit steppers
    (``B2+B6-step@SSPRK104``).
    The ``MODE_COLUMNS`` instance adds
    ``+kinds`` where it reads per-column BC kinds (B1-batched) and ``+B8``
    where it reads per-column geometry: ``features`` is ``(kinds,
    geometry)`` of a run (:func:`per_column_features`), both by default,
    as the instance reads them."""
    if mode & MODE_COLUMNS:
        kinds, geometry = features
        return mode_name(mode & ~MODE_COLUMNS) + ("+kinds" if kinds else "") + ("+B8" if geometry else "")
    if mode & MODE_RK:
        return mode_name(mode & ~MODE_RK) + "@" + _STEPPER_NAMES[mode & MODE_RK]
    policy = {MODE_FREEZE_RATE: "+B3-rate", MODE_FREEZE_EQ: "+B3-eq", MODE_NO_ICE: "-no-ice"}.get(
        mode & _FREEZE_OR_NO_ICE, "")
    if mode & MODE_LAND:
        name = "B6" + ("-step" if mode & MODE_SURFACE_STEP else "")
        name += ("" if mode & MODE_MOST else "-pond") + ("-water" if mode & MODE_WATER else "")
        return ("B2+" + name if mode & MODE_LAGGED else name) + policy
    branch = {MODE_WATER: "-water", MODE_HEAT: "-heat"}.get(mode & (MODE_WATER | MODE_HEAT), "")
    if mode & MODE_IMPLICIT:
        name = _STEPPER_NAMES[mode & MODE_IMPLICIT] + branch + ("-no-ice" if mode & MODE_NO_ICE else "")
        name += ("-pcr" if mode & MODE_PCR else "") + ("+B2" if mode & MODE_LAGGED else "")
        name += {MODE_FREEZE_RATE: "+B3-rate", MODE_FREEZE_EQ: "+B3-eq"}.get(
            mode & (MODE_FREEZE_RATE | MODE_FREEZE_EQ), "")
        return name + ("+B5" if mode & MODE_MOST else "")
    if mode & MODE_MOST:
        return ("B2+B5" if mode & MODE_LAGGED else "B5") + policy
    name = "B2" if mode & MODE_LAGGED else "B1"
    if branch:
        return name + branch + ("-no-ice" if mode & MODE_NO_ICE else "")
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
    the rate sources).  The other explicit steppers alike: SSPRK104's q1
    and q2 are the two stage states, and the state itself its third
    register (read up to its fifth stage, written by its last).  Implicit:
    the iterate and the stage constants (three fields each), the sweep's F,
    K and C, the solver's cp and dp (Thomas) or two sets of (a, c, d, b)
    (PCR), then the lagged coefficients.  The column-tile kernel
    (:data:`TILE_MODES`) keeps its stage registers in shared memory: none."""
    if mode & ~MODE_RK in TILE_MODES:
        return 0
    if mode & MODE_IMPLICIT:
        lagged = (5 if mode & MODE_FREEZE_RATE else 4) if mode & MODE_LAGGED else 0
        return 9 + (8 if mode & MODE_PCR else 2) + lagged
    if not mode & MODE_LAGGED:
        return 6
    return 11 if mode & MODE_FREEZE_RATE else 10


#: the column-tile kernel's threads per block (``kTileMaxThreads`` of ``csrc/tile_column.cuh``) and its launch
#: bounds' blocks per SM by value size (``TileMinBlocks``: f64 at 65,536 / (256 x 2) = 128 registers a thread, f32
#: at 85)
TILE_MAX_THREADS = 256
TILE_MIN_BLOCKS = {4: 3, 8: 2}
#: the most dynamic shared memory of a block (227 KB), the shared memory of an SM (228 KB) and what the runtime
#: keeps of it per block (1 KB), on Hopper
TILE_MAX_SMEM, SM_SMEM, SM_SMEM_PER_BLOCK = 232448, 233472, 1024
#: an SM's registers and resident threads, and its most resident blocks
SM_REGISTERS, SM_THREADS, SM_BLOCKS = 65536, 2048, 32
#: the column-tile kernel's registers a thread, per value size, as ptxas reported them for sm_90a (f32 80, f64
#: 126-128; ``chip_smoke.py``'s build prints them)
TILE_REGISTERS = {4: 80, 8: 128}
#: ``sizeof(Column<T>)`` per value size (``csrc/tile_columns_kernel.cu`` asserts it), and the cell planes besides
#: the registers: the five published center fields and z (then two face planes of nz + 1 values)
TILE_COLUMN_BYTES = {4: 168, 8: 320}
TILE_PLANES = 6


def stage_registers(stages) -> int:
    """The stage registers a :func:`stage_table` touches: 1 (ForwardEuler),
    2 (SSPRK22) or 3 (SSPRK33, SSPRK104); an axpy's auxiliary register is
    never read (``tile_registers`` of ``csrc/tile_column.cuh``)."""
    return 1 + max(max(reg_in, reg_out, reg_aux if kind != STAGE_AXPY else 0)
                   for kind, reg_in, reg_out, reg_aux, _ in stages)


def tile_smem_bytes(nz: int, columns: int, n_regs: int, itemsize: int) -> int:
    """The column-tile kernel's dynamic shared memory for a block of
    ``columns`` columns (``tile_smem_bytes`` of ``csrc/tile_column.cuh``):
    each column's ``Column<T>`` at a stride of an odd number of 8-byte
    words, per cell ``3 n_regs`` register values, the published center
    fields and z, and per face the water and energy fluxes."""
    words = -(-TILE_COLUMN_BYTES[itemsize] // 8) | 1
    return columns * (8 * words + ((3 * n_regs + TILE_PLANES) * nz + 2 * (nz + 1)) * itemsize)


TilePlan = collections.namedtuple("TilePlan", "columns lanes smem_bytes blocks_per_sm")


def tile_plan(nz: int, itemsize: int, n_regs: int, tile_cols: int = 128) -> TilePlan:
    """The column-tile kernel's block of :data:`TILE_MAX_THREADS` threads for
    columns of ``nz`` levels in values of ``itemsize`` bytes under a stepper
    of ``n_regs`` stage registers (:func:`stage_registers`): ``columns`` per
    block (at most ``tile_cols``, the run's) times ``lanes`` level lanes (a
    power of two), each thread taking levels ``lane, lane + lanes, ...`` of
    its column, its shared bytes and the blocks an SM holds (by shared
    memory, threads and :data:`TILE_REGISTERS`).  Of the lane counts it
    picks the one that keeps the most threads with a level to work on
    resident per SM (blocks x columns x nz / ceil(nz / lanes)), the fewest
    lanes on a tie.  Raises ``ValueError`` where one column does not fit a
    block's shared memory (beyond about 1,700 levels in f64)."""
    regs = -(-TILE_REGISTERS[itemsize] // 8) * 8
    best, lanes = None, 1
    while lanes <= TILE_MAX_THREADS and lanes < 2 * nz:
        columns = min(TILE_MAX_THREADS // lanes, int(tile_cols))
        smem = tile_smem_bytes(nz, columns, n_regs, itemsize)
        if smem <= TILE_MAX_SMEM:
            blocks = min(SM_SMEM // (smem + SM_SMEM_PER_BLOCK), SM_THREADS // (columns * lanes),
                         SM_REGISTERS // (regs * columns * lanes), SM_BLOCKS)
            busy = blocks * columns * nz / -(-nz // lanes)
            if blocks and (best is None or busy > best[0]):
                best = (busy, TilePlan(columns, lanes, smem, blocks))
        lanes *= 2
    if best is None:
        raise ValueError(
            f"a column of nz={nz} levels takes {tile_smem_bytes(nz, 1, n_regs, itemsize)} B of shared memory in the "
            f"column-tile kernel, past a block's {TILE_MAX_SMEM} B")
    return best[1]


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


def stage_table(stepper, dt, dtype) -> list:
    """The explicit kernel's stages of one step of ``stepper`` (ForwardEuler,
    SSPRK22, SSPRK33 or SSPRK104; ``enum StageKind`` of the header): per
    stage ``(kind, register read, register written, auxiliary register,
    (h, c1, c2, c3, c4))``, registers 0 for the state and 1, 2 for the two
    scratch states.  Each stage is ``n = u + h f(u)`` of the register it
    reads; ``h`` is computed from ``dt`` in ``dtype`` as the eager step
    computes it (``dt``, ``dt / 6.0``, ``0.1 * dt``), the weights are the
    step's Python numbers, rounded to ``dtype`` by the kernel as the eager
    step rounds them."""
    base = _base_stepper(stepper)
    dt_t = torch.as_tensor(dt, dtype=dtype)
    h = float(dt_t)
    if type(base) is ForwardEuler:
        return [(STAGE_AXPY, 0, 0, 0, (h, 0.0, 0.0, 0.0, 0.0))]
    if type(base) is SSPRK22:
        return [(STAGE_AXPY, 0, 1, 0, (h, 0.0, 0.0, 0.0, 0.0)),
                (STAGE_COMB, 1, 0, 0, (h, 0.5, 0.5, 0.0, 0.0))]
    if type(base) is SSPRK33:
        return [(STAGE_AXPY, 0, 1, 0, (h, 0.0, 0.0, 0.0, 0.0)),
                (STAGE_COMB, 1, 2, 0, (h, 0.75, 0.25, 0.0, 0.0)),
                (STAGE_COMB, 2, 0, 0, (h, 1.0 / 3.0, 2.0 / 3.0, 0.0, 0.0))]
    if type(base) is SSPRK104:
        sixth, tenth = float(dt_t / 6.0), float(0.1 * dt_t)
        axpy = (STAGE_AXPY, 1, 1, 0, (sixth, 0.0, 0.0, 0.0, 0.0))
        return ([(STAGE_AXPY, 0, 1, 0, (sixth, 0.0, 0.0, 0.0, 0.0))] + [axpy] * 3
                + [(STAGE_SPLIT, 1, 1, 2, (sixth, 1.0 / 25.0, 9.0 / 25.0, 15.0, -5.0))] + [axpy] * 4
                + [(STAGE_FINAL, 1, 0, 2, (tenth, 3.0 / 5.0, 0.0, 0.0, 0.0))])
    raise TypeError(f"{type(base).__name__} is not an explicit stepper of the kernel")


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


def _most_top(soil: SoilModel) -> bool:
    return isinstance(soil.boundary_conditions.top, PrescribedAtmosForcing)


def exchanged_components(model) -> tuple:
    """The top face's components whose flux values the kernel's surface
    exchange supplies: both under MOST, the water flux of a LandModel."""
    soil = _soil_of(model)
    if _most_top(soil):
        return ("energy", "hydrology")
    return ("hydrology",) if isinstance(model, LandModel) else ()


def bc_tables(
    model, t0, dt, n_steps: int, ncol: int, device, reuse=None,
    stepper: AbstractTimestepper = SSPRK33(),
) -> list:
    """:func:`bc_value_table` of each BC slot of the soil (``None`` for free
    drainage, which has no value, and for a prescribed component's slot; a
    one-value zero table for a slot the surface exchange supplies).  Where
    ``reuse`` is given, the tables of values that do not depend on time are
    taken from it and only the callable values are evaluated."""
    soil = _soil_of(model)
    exchanged = exchanged_components(model)
    tables = []
    for j, (face, comp) in enumerate(BC_SLOTS):
        if face == "top" and comp in exchanged:
            tables.append(reuse[j] if reuse is not None else (
                torch.zeros(1, dtype=soil.float_dtype, device=device), 0, 0))
            continue
        bc = _bc_of(soil, face, comp)
        if isinstance(bc, (FreeDrainage, NoBC)) or not _dynamic(soil, comp):
            tables.append(None)
            continue
        value = getattr(bc, {VerticalFlux: "flux", Dirichlet: "state_value", BatchedBC: "value"}[type(bc)])
        if reuse is not None and not callable(value):
            tables.append(reuse[j])
        else:
            tables.append(bc_value_table(
                value, t0, dt, n_steps, ncol, soil.float_dtype, device, stepper
            ))
    return tables


def cuda_kind_codes(kind):
    """The kernel's kind codes (``enum BCKind``) of ``BatchedBC`` codes, as
    int32: FLUX (0) -> BC_FLUX, DIRICHLET (1) -> BC_DIRICHLET, any other ->
    BC_FREE_DRAINAGE, the last branch of the eager select."""
    kind = torch.as_tensor(kind)
    return torch.where(kind == BCKind.FLUX, BC_FLUX,
                       torch.where(kind == BCKind.DIRICHLET, BC_DIRICHLET, BC_FREE_DRAINAGE)).to(torch.int32)


def bc_kind_columns(model, ncol: int, device) -> list:
    """Per BC slot, ``None`` or, for a ``BatchedBC`` slot, ``(codes, column
    stride)``: the kernel's kind codes (:func:`cuda_kind_codes`), one per
    column (stride 1) or one for all (stride 0), on ``device``."""
    soil = _soil_of(model)
    out = []
    for face, comp in BC_SLOTS:
        bc = getattr(getattr(soil.boundary_conditions, face), comp, None)
        if not isinstance(bc, BatchedBC):
            out.append(None)
            continue
        codes = cuda_kind_codes(bc.kind)
        if codes.numel() == 1:
            out.append((codes.reshape(1).to(device), 0))
        elif tuple(codes.shape) == (ncol,):
            out.append((codes.contiguous().to(device), 1))
        else:
            raise ValueError(
                f"BatchedBC kinds of the {face} {comp} slot have shape {tuple(codes.shape)}; "
                f"expected a scalar or ({ncol},)"
            )
    return out


def _surface_values(model) -> list:
    """The value of each :data:`SURFACE_NAMES` input the model's mode reads,
    else ``None``."""
    soil = _soil_of(model)
    values = [None] * _S
    if _most_top(soil):
        atmos = soil.boundary_conditions.top
        for j, name in enumerate(SURFACE_NAMES[:6]):
            values[j] = getattr(atmos, name)
        values[6], values[7] = soil.soil_param_set.z_0m, soil.soil_param_set.z_0s
    if isinstance(model, LandModel):
        values[8], values[9] = model.surface.tau_pond, model.surface.h_evap_smoothing
    return values


def surface_tables(model, t0, dt, n_steps: int, ncol: int, device, reuse=None,
                   stepper: AbstractTimestepper = SSPRK33(), forced=()) -> list:
    """:func:`bc_value_table` of each :data:`SURFACE_NAMES` input (``None``
    where the mode reads none, and for the inputs named in ``forced``, which
    streamed forcing rows supply): callable atmosphere fields at every stage
    time, the others once; with ``reuse``, the tables of values that do not
    depend on time are taken from it."""
    dtype = _soil_of(model).float_dtype
    tables = []
    for j, value in enumerate(_surface_values(model)):
        if value is None or SURFACE_NAMES[j] in forced:
            tables.append(None)
        elif reuse is not None and not callable(value):
            tables.append(reuse[j])
        else:
            tables.append(bc_value_table(value, t0, dt, n_steps, ncol, dtype, device, stepper))
    return tables


def precipitation_table(precipitation, times, dtype, device):
    """The rain rate at each of ``times`` as a ``(len(times),)`` table on
    ``device``, checked non-negative (on the host) and floored at zero as the
    land rhs floors it.  The package's declarative rain classes are
    evaluated in one call over all the times; another callable once per
    time.  A per-column rate raises ``ValueError``."""
    if isinstance(precipitation, (ConstantPrecipitation, PulsePrecipitation)):
        table = torch.as_tensor(precipitation(torch.stack(times)), dtype=dtype).cpu()
        if table.dim() == 0:
            table = table.expand(len(times))
    else:
        table = torch.stack([torch.as_tensor(precipitation(t), dtype=dtype).cpu() for t in times])
    if tuple(table.shape) != (len(times),):
        raise ValueError(
            "the fused kernel advances time internally, so per-column "
            "precipitation arrays cannot be tabulated: use a scalar-returning "
            "precipitation(t), or the eager engine"
        )
    check_rain(table)
    return torch.clamp(table, min=0.0).contiguous().to(device)


def profile_tables(model: SoilModel, zc, times, reuse=None) -> list:
    """The prescribed profiles at ``times`` on ``zc``'s device, in the order
    of :data:`PROFILE_NAMES` (``None`` for a profile the branch does not
    prescribe): T for the water-only branch, vartheta_l and theta_i for the
    heat-only branch.  A profile with one value per level is a
    ``(len(times), nz)`` table.  One that varies by column (on ``zc`` of
    ``(nz, ncol)``, kernel mode B8, or by its own values) is a
    ``(len(times), nz, ncol)`` table, or ``(1, nz, ncol)`` if it does not
    depend on time; past :data:`PROFILE_TABLE_BYTES` it raises
    ``ValueError`` naming its size.  The package's default profiles, which
    do not depend on time, are evaluated once, and taken from ``reuse``
    where given."""
    fns = [None] * _R
    if isinstance(model.energy_model, PrescribedTemperatureModel):
        fns[0] = model.energy_model.T_profile
    if isinstance(model.hydrology_model, PrescribedHydrologyModel):
        fns[1] = model.hydrology_model.vartheta_l_profile
        fns[2] = model.hydrology_model.theta_i_profile
    nz = zc.shape[0]
    tables = []
    for j, (name, fn) in enumerate(zip(PROFILE_NAMES, fns)):
        if fn is None:
            tables.append(None)
            continue
        constant = fn in (_default_T_profile, _default_zero_profile)
        if constant and reuse is not None and reuse[j] is not None:
            tables.append(reuse[j])
            continue
        rows = [torch.as_tensor(fn(zc, t), dtype=model.float_dtype, device=zc.device)
                for t in (times[:1] if constant else times)]
        shape = torch.broadcast_shapes((nz, 1), *(r.shape for r in rows))
        if shape == (nz, 1):
            table = torch.stack([r.expand(nz, 1).reshape(nz) for r in rows])
            tables.append((table.expand(len(times), nz) if constant else table).contiguous())
            continue
        if len(shape) != 2 or shape[0] != nz:
            raise ValueError(
                f"the {name} profile returned shape {tuple(shape)}; expected (nz, 1) or (nz, ncol) "
                f"with nz={nz}"
            )
        nbytes = len(rows) * shape[0] * shape[1] * (torch.finfo(model.float_dtype).bits // 8)
        if nbytes > PROFILE_TABLE_BYTES:
            raise ValueError(
                f"the {name} profile varies by column: its table of {len(rows)} rows x {shape[0]} x "
                f"{shape[1]} takes {nbytes} B per launch, past the budget of {PROFILE_TABLE_BYTES} B "
                "(PROFILE_TABLE_BYTES); take fewer steps per call"
            )
        tables.append(torch.stack([r.expand(shape) for r in rows]).contiguous())
    return tables


# --------------------------------------------------------------------------
# Plain version and the run object
# --------------------------------------------------------------------------


def _on_grid(stepper, grid):
    """``stepper`` with its grid (the implicit steppers') replaced by ``grid``."""
    return dataclasses.replace(stepper, grid=grid) if hasattr(stepper, "grid") else stepper


def geometry_grid(soil: SoilModel, geometry, dtype, device) -> ColumnGrid:
    """The grid of a run: the model's, or with ``geometry = (dz, zc)``
    (``streamed_geometry``) a grid of those rows, in ``dtype`` on
    ``device``."""
    if geometry is None:
        return make_function_space(soil.domain, dtype, device)
    dz, zc = (torch.as_tensor(x, dtype=dtype, device=device) for x in geometry)
    return ColumnGrid(zc=zc, zf=None, dz=dz, nz=zc.shape[0], batch_shape=tuple(dz.shape))


def fused_column_run_plain(model, stepper: AbstractTimestepper, dt, steps_per_call: int, Y: dict,
                           t0, forcing=None, forcing_time_grid=None, geometry=None) -> dict:
    """The plain PyTorch version of one kernel launch: ``steps_per_call``
    eager ``stepper.step`` calls of the model's rhs from ``t0``, with the
    model's step policies wrapped around ``stepper`` as ``Simulation`` wraps
    them (projection inside, lagged coefficients or the LandModel's frozen
    exchange outside) and an implicit stepper's grid rebuilt on the state's
    device.  With ``forcing`` (kernel B7), step ``i`` installs its row of
    each field in the model (``_install_forcing_rows``) and wraps the step
    policies around that row-local model: row ``i``, or with
    ``forcing_time_grid = (t_start, dt_forcing, n_rows)`` the row of the
    step's start time (``time_row``).  ``geometry = (dz, zc)`` replaces the
    model's grid (``streamed_geometry``).  Returns a new state and leaves
    ``Y`` as it was."""
    soil = _soil_of(model)
    dtype = soil.float_dtype
    device = Y[soil.name][prognostic_vars(soil)[0]].device
    dt_t = torch.as_tensor(dt, dtype=dtype)
    if forcing is not None:
        grid = geometry_grid(soil, geometry, dtype, device)
        stepper = wrap_stepper_with_projection(_on_grid(_base_stepper(stepper), grid), soil)
        Ya = {"zc": grid.zc, soil.name: {}}
        atmos, precip = _split_routing(model, tuple(forcing))
        rows = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in forcing.items()}
        for i, t in enumerate(step_times(t0, dt, steps_per_call, dtype)):
            j = i if forcing_time_grid is None else time_row(t, *forcing_time_grid)
            m = _install_forcing_rows(model, {k: v[j] for k, v in rows.items()}, atmos, precip)
            rhs, st = _row_local_step(stepper, m, grid)
            Y = st.step(rhs, Y, Ya, t, dt_t)
        return Y
    step = plain_step(model, stepper, device, geometry)
    for t in step_times(t0, dt, steps_per_call, dtype):
        Y = step(Y, t, dt_t)
    return Y


def plain_step(model, stepper: AbstractTimestepper, device, geometry=None):
    """``step(Y, t, dt) -> Y``: one step of :func:`fused_column_run_plain`
    without forcing rows: the model's rhs on the run's grid (on ``device``,
    or ``geometry``), ``stepper`` with the projection inside and lagged
    coefficients or the LandModel's frozen exchange outside, and ``Ya =
    {"zc": ..., soil: {}}``."""
    soil = _soil_of(model)
    grid = geometry_grid(soil, geometry, soil.float_dtype, device)
    stepper = wrap_stepper_with_projection(_on_grid(_base_stepper(stepper), grid), soil)
    if isinstance(model, LandModel):
        stepper, rhs = wrap_stepper_for_land(stepper, model, grid), make_land_rhs(model, grid)
    else:
        stepper, rhs = wrap_stepper_for_soil(stepper, model, grid), make_rhs(model, grid)
    Ya = {"zc": grid.zc, soil.name: {}}
    return lambda Y, t, dt: stepper.step(rhs, Y, Ya, t, dt)


class FusedColumnRun:
    """``run(Y, t0, forcing=None, dt_run=None) -> Y``: advance
    ``steps_per_call`` steps of ``stepper`` from ``t0`` at the factory's
    ``dt``, or at ``dt_run`` (:meth:`step_size`), **in place**: the tensors of ``Y`` (a
    LandModel's pond ``h_s`` too) are overwritten and ``Y`` is returned.
    CUDA tensors go through a kernel (or the call raises); CPU tensors
    through :func:`fused_column_run_plain` with the same stepper.  A run
    built with ``forcing_fields`` takes their rows (kernel B7; see
    :func:`make_fused_column_run`).  Each launch adds one to the module's
    ``LAUNCHES`` under :attr:`name`: the name of its mode, with ``+B7`` for
    streamed rows (``+B7-time`` time-indexed), ``+kinds`` for per-column BC
    kinds (B1-batched) and ``+B8`` for per-column geometry, and last the
    explicit stepper but SSPRK33 (``B6+B3-rate+B7@ForwardEuler``)."""

    def __init__(self, model, stepper, dt: float, steps_per_call: int, tile_cols: int,
                 forcing_fields=(), forcing_time_grid=None, streamed_geometry=None):
        self.model = model
        self.soil = _soil_of(model)
        self.stepper = _base_stepper(stepper)
        self.dt = float(dt)
        self.steps_per_call = int(steps_per_call)
        self.tile_cols = int(tile_cols)
        self.mode = kernel_mode(model, self.stepper, streamed_geometry)
        self.fields = prognostic_vars(self.soil)
        self.forcing_fields = tuple(forcing_fields)
        self.forcing_time_grid = forcing_time_grid
        #: rows of each forcing field per launch: one per step, or the table
        self.n_frows = int(forcing_time_grid[2]) if forcing_time_grid else self.steps_per_call
        self.geometry = streamed_geometry
        #: per-column BC kinds (B1-batched) and per-column geometry (B8)
        self.batched, self.variable = per_column_features(model, streamed_geometry)
        self.name = mode_name(self.mode & ~MODE_RK, (self.batched, self.variable))
        if self.forcing_fields:
            self.name += "+B7-time" if forcing_time_grid else "+B7"
        if self.mode & MODE_RK:
            self.name += "@" + _STEPPER_NAMES[self.mode & MODE_RK]
        self._device_inputs = {}  # (device, ncol) -> _inputs()
        self._device_kinds = {}  # (device, ncol) -> bc_kind_columns()

    def _pond(self, Y: dict):
        return Y[self.model.surface.name]["h_s"] if self.mode & MODE_LAND else None

    def step_size(self, dt_run=None) -> float:
        """The step size of a launch: ``dt_run`` rounded to the model dtype
        (kernel mode B1-dt, as the JAX kernel's ``jnp.asarray(dt_run,
        dtype)``), or the factory's ``dt``."""
        if dt_run is None:
            return self.dt
        return float(torch.as_tensor(dt_run, dtype=self.soil.float_dtype, device="cpu"))

    def __call__(self, Y: dict, t0, forcing=None, dt_run=None) -> dict:
        dt = self.step_size(dt_run)
        name = self.soil.name
        fields = [Y[name][k] for k in self.fields]
        device = fields[0].device
        rows = self._forcing_rows(forcing, fields[0].shape[-1], device)
        if device.type == "cpu":
            Yn = fused_column_run_plain(
                self.model, self.stepper, dt, self.steps_per_call, Y, t0,
                forcing=None if rows is None else {k: v[0] for k, v in rows.items()},
                forcing_time_grid=self.forcing_time_grid, geometry=self.geometry,
            )
            for group in Yn:
                for k, v in Y[group].items():
                    v.copy_(Yn[group][k])
            return Y
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        self._check_state(fields, self._pond(Y), device)
        if torch.is_grad_enabled() and any(
                f.requires_grad for f in fields + [self._pond(Y)] if f is not None):
            raise ValueError(
                "the state requires grad, but the kernel writes it in place where autograd cannot "
                "see: build the run with differentiable=True (kernel B9), or run under torch.no_grad()"
            )
        self._launch(fields, self._pond(Y), t0, device, rows, dt)
        return Y

    def _forcing_rows(self, forcing, ncol: int, device):
        """``{field: (rows, row stride, column stride)}`` of the forcing
        passed to a run built with ``forcing_fields``, each in the model
        dtype on ``device`` (rows already there are used in place, views
        included): ``(n_frows,)`` scalar rows (column stride 0) or
        ``(n_frows, ncol)`` per-column rows; ``None`` without forcing."""
        if self.forcing_fields and forcing is None:
            raise ValueError(
                f"this fused run streams forcing fields {self.forcing_fields}; pass "
                f"run(Y, t0, forcing=...) with ({self.n_frows},) or ({self.n_frows}, ncol) rows"
            )
        if forcing is None:
            return None
        if not self.forcing_fields:
            raise ValueError("forcing passed but the run was built without forcing_fields")
        if set(forcing) != set(self.forcing_fields):
            raise KeyError(
                f"forcing keys {sorted(forcing)} != declared forcing_fields {sorted(self.forcing_fields)}"
            )
        rows = {}
        for k in self.forcing_fields:
            v = torch.as_tensor(forcing[k], dtype=self.soil.float_dtype, device=device)
            if tuple(v.shape) == (self.n_frows,):
                rows[k] = (v, v.stride(0), 0)
            elif tuple(v.shape) == (self.n_frows, ncol):
                rows[k] = (v, v.stride(0), v.stride(1))
            else:
                raise ValueError(
                    f"forcing field {k!r} has shape {tuple(v.shape)}; expected "
                    f"({self.n_frows},) or ({self.n_frows}, {ncol})"
                )
        return rows

    def _check_state(self, fields, h_s, device):
        dtype = self.soil.float_dtype
        nz = self.soil.domain.nelements
        for f in fields + ([h_s] if h_s is not None else []):
            if f.device != device or f.dtype != dtype:
                raise ValueError(
                    f"state tensors must all be {dtype} on {device}; got {f.dtype} on {f.device}"
                )
            if not f.is_contiguous():
                raise ValueError("state tensors must be contiguous")
        for f in fields:
            if f.dim() != 2 or f.shape[0] != nz or f.shape != fields[0].shape:
                raise ValueError(
                    f"state tensors must share the shape (nz={nz}, ncol); got "
                    f"{[tuple(g.shape) for g in fields]}"
                )
        if h_s is not None and tuple(h_s.shape) != (fields[0].shape[1],):
            raise ValueError(
                f"pond state h_s of shape {tuple(h_s.shape)} does not match the flat "
                f"column batch ({fields[0].shape[1]},)"
            )

    def _inputs(self, ncol: int, device):
        """``(params, zc, dz, BC tables, surface tables, profile tables)`` on
        ``device``, built once per column count; a launch rebuilds the tables
        of values that depend on time and reuses the others."""
        key = (str(device), ncol)
        if key not in self._device_inputs:
            soil = self.soil
            dtype = soil.float_dtype
            values = column_params(soil)
            params = [
                _column_tensor(values[n], ncol, dtype, device, f"parameter {n}")
                for n in PARAM_NAMES
            ]
            grid = geometry_grid(soil, self.geometry, dtype, device)
            zc = grid.zc.reshape(grid.nz, -1)
            dz = grid.dz
            if torch.is_tensor(dz):  # per column (B8)
                dz = dz.reshape(-1)
                if tuple(dz.shape) != (ncol,) or tuple(zc.shape) != (grid.nz, ncol):
                    raise ValueError(
                        f"per-column geometry of shapes dz {tuple(dz.shape)}, zc {tuple(zc.shape)} "
                        f"does not match the state's (nz={grid.nz}, ncol={ncol})"
                    )
            else:
                zc = zc.contiguous()
            args = (self.model, 0.0, self.dt, self.steps_per_call, ncol, device)
            times, _ = table_times(self.stepper, 0.0, self.dt, self.steps_per_call, dtype)
            self._device_inputs[key] = (
                params, zc, dz, bc_tables(*args, stepper=self.stepper),
                surface_tables(*args, stepper=self.stepper), profile_tables(soil, zc, times),
            )
        return self._device_inputs[key]

    def _kinds(self, ncol: int, device) -> list:
        """:func:`bc_kind_columns` on ``device``, built once per column count."""
        key = (str(device), ncol)
        if key not in self._device_kinds:
            self._device_kinds[key] = bc_kind_columns(self.model, ncol, device)
        return self._device_kinds[key]

    def tables(self, ncol: int, device, t0, dt=None) -> tuple:
        """``(BC, profile, surface, precipitation)`` tables of a launch from
        ``t0`` at step size ``dt`` (the factory's by default; ``None`` for
        the tables the mode does not read and for the fields streamed as
        forcing rows): the host work of a launch besides the argument
        struct.  The tables :meth:`_inputs` keeps per column count hold only
        values that do not depend on time, so they serve every ``dt``."""
        dtype = self.soil.float_dtype
        dt = self.dt if dt is None else dt
        _, zc, _, constant_bc, constant_surface, constant_profiles = self._inputs(ncol, device)
        args = (self.model, t0, dt, self.steps_per_call, ncol, device)
        bc = bc_tables(*args, reuse=constant_bc, stepper=self.stepper)
        times, _ = table_times(self.stepper, t0, dt, self.steps_per_call, dtype)
        profiles = profile_tables(self.soil, zc, times, reuse=constant_profiles)
        surface = precip = None
        if self.mode & (MODE_MOST | MODE_LAND):
            surface = surface_tables(*args, reuse=constant_surface, stepper=self.stepper,
                                     forced=self.forcing_fields)
        if self.mode & MODE_LAND and "precipitation" not in self.forcing_fields:
            precip = precipitation_table(self.model.surface.precipitation, times, dtype, device)
        return bc, profiles, surface, precip

    def launch_args(self, fields, h_s, t0, device, rows=None, dt=None) -> tuple:
        """``(argument struct, tensors it points to)`` of a launch from
        ``t0`` at step size ``dt`` (the factory's by default); the caller
        keeps the tensors alive until it is queued."""
        dtype = self.soil.float_dtype
        dt = self.dt if dt is None else dt
        nz, ncol = fields[0].shape
        params, zc, dz = self._inputs(ncol, device)[:3]
        tables, profiles, surface, precip = self.tables(ncol, device, t0, dt)
        kinds = self._kinds(ncol, device)
        if not self.mode & MODE_COLUMNS and any(p is not None and p.dim() == 3 for p in profiles):
            raise ValueError("a prescribed profile varies by column after t = 0 but not at t = 0: "
                             "per-column profiles must vary by column from the start")
        scratch = torch.empty(scratch_fields(self.mode) * nz * ncol, dtype=dtype, device=device)
        args = kernel_args(
            self.model, fields, scratch, zc, dz, params, tables, self.steps_per_call, dt,
            stepper=self.stepper, profiles=profiles, surface=surface, precip=precip, h_s=h_s,
            forcing=rows, forcing_time_grid=self.forcing_time_grid, t0=t0, kinds=kinds, mode=self.mode,
        )
        return args, (scratch, tables, profiles, surface, precip, rows)

    def _launch(self, fields, h_s, t0, device, rows=None, dt=None):
        dtype = self.soil.float_dtype
        args, keep = self.launch_args(fields, h_s, t0, device, rows, dt)
        lib_name, fn_name = _entry(self.mode, dtype)
        lib = load_library(f"{lib_name}_{'f32' if dtype == torch.float32 else 'f64'}")
        block = (self.tile_cols,)
        if lib_name == "tile_columns_kernel":
            stages = stage_table(self.stepper, dt, dtype)
            block = tile_plan(args.nz, torch.finfo(dtype).bits // 8, stage_registers(stages), self.tile_cols)[:3]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, fn_name)(ctypes.byref(args), *block, ctypes.c_void_p(stream))
        del keep
        if rc != 0:
            raise RuntimeError(f"column kernel launch failed: cudaError {rc}")
        LAUNCHES[self.name] += 1


def kernel_args(model, fields, scratch, zc, dz, params, tables, n_steps, dt,
                stepper: AbstractTimestepper = SSPRK33(), profiles=None, surface=None,
                precip=None, h_s=None, forcing=None, forcing_time_grid=None, t0=0.0,
                kinds=None, mode=None) -> _KernelArgs:
    """Pack the kernel's argument struct.  ``fields`` are the state tensors
    in the order of ``prognostic_vars`` of the soil; ``zc`` is ``(nz, 1)``
    or ``(nz, ncol)`` (any strides) and ``dz`` a number or, per column, a
    ``(ncol,)`` tensor (B8); ``kinds`` is :func:`bc_kind_columns`
    (B1-batched); ``mode`` the run's mode word (by default
    :func:`kernel_mode` of the model); ``surface``, ``precip`` and ``h_s``
    are the surface modes' tables and pond;
    ``forcing`` maps streamed fields to ``(rows, row stride, column
    stride)`` (kernel B7), step-indexed, or time-indexed on
    ``forcing_time_grid = (t_start, dt_forcing, n_rows)`` from the launch's
    start time ``t0``.  The caller keeps every tensor alive until the launch
    has been queued."""
    soil = _soil_of(model)
    nz, ncol = fields[0].shape
    ps = soil.earth_param_set
    hydrology = soil.hydrology_model
    state = dict(zip(prognostic_vars(soil), fields))
    base = _base_stepper(stepper)
    exchanged = exchanged_components(model)
    a = _KernelArgs()
    for name in ("vartheta_l", "theta_i", "rho_e_int"):
        if name in state:
            setattr(a, name, state[name].data_ptr())
    a.scratch = scratch.data_ptr()
    a.zc = zc.data_ptr()
    a.zc_level_stride = zc.stride(0)
    a.zc_col_stride = zc.stride(1) if zc.shape[1] > 1 else 0
    for j, (t, stride) in enumerate(params):
        a.param_ptr[j] = t.data_ptr()
        a.param_stride[j] = stride
    for j, ((face, comp), table) in enumerate(zip(BC_SLOTS, tables)):
        if face == "top" and comp in exchanged:
            a.bc_kind[j] = _BC_KIND[VerticalFlux]
        elif _dynamic(soil, comp):
            a.bc_kind[j] = _BC_KIND.get(type(_bc_of(soil, face, comp)), 0)
        if table is not None:
            a.bc_ptr[j] = table[0].data_ptr()
            a.bc_row_stride[j] = table[1]
            a.bc_col_stride[j] = table[2]
    for j, column in enumerate(kinds or ()):
        if column is not None:
            a.bc_kind_col[j] = column[0].data_ptr()
            a.bc_kind_col_stride[j] = column[1]
    for j, table in enumerate(profiles or ()):
        if table is not None:
            a.profile[j] = table.data_ptr()
            a.profile_row_stride[j] = table.stride(0) if table.shape[0] > 1 else 0
            per_column = table.dim() == 3
            a.profile_level_stride[j] = table.stride(1) if per_column else 1
            a.profile_col_stride[j] = table.stride(2) if per_column and table.shape[2] > 1 else 0
    for j, table in enumerate(surface or ()):
        if table is not None:
            a.surface_ptr[j] = table[0].data_ptr()
            a.surface_row_stride[j] = table[1]
            a.surface_col_stride[j] = table[2]
    if precip is not None:
        a.precip = precip.data_ptr()
        a.precip_row_stride, a.precip_col_stride = 1, 0
    dtype = soil.float_dtype
    a.t0 = float(torch.as_tensor(t0, dtype=dtype))
    if forcing:
        a.frow_mode = FROW_TIME if forcing_time_grid is not None else FROW_STEP
        for name, (rows, row_stride, col_stride) in forcing.items():
            if name == "precipitation":
                a.forced |= 1 << _S
                a.precip = rows.data_ptr()
                a.precip_row_stride, a.precip_col_stride = row_stride, col_stride
            else:
                j = SURFACE_NAMES.index(name)
                a.forced |= 1 << j
                a.surface_ptr[j] = rows.data_ptr()
                a.surface_row_stride[j], a.surface_col_stride[j] = row_stride, col_stride
        if forcing_time_grid is not None:
            t_start, dt_forcing, a.n_frows = forcing_time_grid
            a.t_forcing0 = float(torch.tensor(float(t_start), dtype=dtype))
            a.inv_dt_forcing = float(torch.tensor(1.0 / float(dt_forcing), dtype=dtype))
    if h_s is not None:
        a.h_s = h_s.data_ptr()
    a.nz, a.ncol, a.n_steps = nz, ncol, n_steps
    a.viscosity = int(isinstance(getattr(hydrology, "viscosity_factor", None), TemperatureDependentViscosity))
    a.impedance = int(isinstance(getattr(hydrology, "impedance_factor", None), IceImpedance))
    a.mode = kernel_mode(model, base) if mode is None else mode
    ft = soil.freeze_thaw
    if isinstance(ft, EquilibriumFreezeThaw):
        a.n_iter, a.T_lo, a.T_hi = int(ft.n_iter), float(ft.T_lo), float(ft.T_hi)
    a.rows_per_step = len(base.stage_times(0.0, dt))
    if isinstance(base, _EXPLICIT_STEPPERS):
        stages = stage_table(base, dt, soil.float_dtype)
        a.n_stages = len(stages)
        for s, (kind, reg_in, reg_out, reg_aux, coefs) in enumerate(stages):
            a.stage_kind[s], a.stage_in[s], a.stage_out[s], a.stage_aux[s] = kind, reg_in, reg_out, reg_aux
            for j, value in enumerate(coefs):
                a.stage_c[5 * s + j] = value
    a.iters = int(getattr(base, "iters", 0))
    k = trbdf2_coefficients()
    a.half_g, a.a1, a.a2, a.b_bdf2 = k["half_g"], k["a1"], k["a2"], k["b"]
    a.dt = dt
    if torch.is_tensor(dz):
        a.dz_col = dz.data_ptr()
        a.dz_col_stride = dz.stride(0) if dz.numel() > 1 else 0
    else:
        a.dz = dz
    for name in ("T_0", "rho_cloud_ice", "LH_f0", "rho_cp_l", "rho_cp_i", "rho_cloud_liq", "grav",
                 "von_karman_const", "cp_d", "cp_v", "cp_l", "R_d", "R_v", "LH_v0",
                 "press_triple", "T_triple", "molmass_ratio"):
        setattr(a, name, getattr(ps, name))
    return a


# --------------------------------------------------------------------------
# Factory
# --------------------------------------------------------------------------


def _check_surface(model, rain_forced: bool = False) -> None:
    """Refuse the surface configurations no kernel runs, those the JAX
    kernel's factory refuses: routing and a per-column rain rate
    (``ValueError``), a MOST top without dynamic energy and hydrology
    (``TypeError``).  A rain rate streamed as forcing rows may be per
    column."""
    soil = _soil_of(model)
    land = isinstance(model, LandModel)
    if land and model.surface.runoff is not None:
        raise ValueError(
            "pond runoff routing is a cross-column stencil and cannot run inside "
            "the column kernel: use the eager engine"
        )
    if land and not rain_forced:  # a per-column rain rate raises here, as in the JAX factory
        t0 = torch.zeros((), dtype=soil.float_dtype)
        precipitation_table(model.surface.precipitation, [t0], soil.float_dtype, "cpu")
    if _most_top(soil) and not (_dynamic(soil, "energy") and _dynamic(soil, "hydrology")):
        raise TypeError(
            "Turbulent surface fluxes require dynamic SoilEnergyModel and "
            "SoilHydrologyModel components."
        )


def per_column_features(model, streamed_geometry=None) -> tuple:
    """``(kinds, geometry)``: whether the run reads per-column BC kinds (a
    ``BatchedBC`` slot, kernel mode B1-batched) and per-column geometry (a
    ``VariableDepthColumn``, ``streamed_geometry``, or a prescribed profile
    that varies by column at t = 0 on the model's grid; B8)."""
    soil = _soil_of(model)
    kinds = any(isinstance(getattr(getattr(soil.boundary_conditions, face), comp, None), BatchedBC)
                for face, comp in BC_SLOTS)
    geometry = streamed_geometry is not None or isinstance(soil.domain, VariableDepthColumn)
    return kinds, geometry or _per_column_profiles(soil)


def _per_column_profiles(soil: SoilModel) -> bool:
    fns = []
    if isinstance(soil.energy_model, PrescribedTemperatureModel):
        fns.append(soil.energy_model.T_profile)
    if isinstance(soil.hydrology_model, PrescribedHydrologyModel):
        fns += [soil.hydrology_model.vartheta_l_profile, soil.hydrology_model.theta_i_profile]
    fns = [f for f in fns if f not in (_default_T_profile, _default_zero_profile)]
    if not fns:
        return False
    zc = make_function_space(soil.domain, soil.float_dtype, soil.device).zc
    t0 = torch.zeros((), dtype=soil.float_dtype)
    return any(len(s) == 2 and s[1] > 1 for s in (
        torch.broadcast_shapes((zc.shape[0], 1), torch.as_tensor(f(zc, t0)).shape) for f in fns))


def takes_per_column(mode: int) -> bool:
    """Whether ``mode`` (a mode word with its stepper's bits) takes
    per-column BC kinds and geometry: every explicit mode (the plain soil,
    its branches and each step policy: ``csrc/rk_columns_kernel.cu`` and,
    for SSPRK33 in B1, B2, B3-rate and B1-water, ``csrc/column_kernel.cu``;
    the 48 land modes with forcing rows or without:
    ``csrc/land_columns_kernel.cu``, ``csrc/land_policy_columns_kernel.cu``
    and, for SSPRK33 in B5 and B6, ``csrc/land_kernel.cu``), and every
    implicit mode on the plain soil with each step policy, the water-only
    branch and PCR included (``csrc/implicit_kernel.cu``,
    ``csrc/implicit_columns_kernel.cu``), and under a MOST top with each
    step policy or none, PCR and forcing rows included
    (``csrc/implicit_most_columns_kernel.cu``); but not TR-BDF2 on the
    heat-only branch, which is not queued."""
    return not (mode & MODE_IMPLICIT and mode & MODE_HEAT)


def _check_per_column(model, stepper, streamed_geometry, forcing_fields) -> None:
    """Refuse per-column kinds or geometry in the one mode that does not take
    them (:func:`takes_per_column`): TR-BDF2 on the heat-only branch, which
    is not queued (ROADMAP B1-batched or B8)."""
    kinds, geometry = per_column_features(model, streamed_geometry)
    mode = kernel_mode(model, stepper) & ~MODE_COLUMNS
    if not (kinds or geometry) or takes_per_column(mode):
        return
    item, what = ("B1-batched", "per-column BC kinds (BatchedBC)") if kinds else ("B8", "per-column geometry")
    where = f"in mode {mode_name(mode)}" + (" with streamed forcing rows" if forcing_fields else "")
    raise NotImplementedError(
        f"{what} {where} have no kernel and are not queued (ROADMAP {item}, not queued): the reference's "
        "TRBDF2Soil cannot run the heat-only branch at all (its heat sweep reads theta_i from a state that "
        "holds none, KeyError 'theta_i'), so per-column inputs there would be a feature it lacks"
    )


def _check_model(model, rain_forced: bool = False) -> None:
    if not isinstance(model, (SoilModel, LandModel)):
        raise TypeError(f"expected a SoilModel or a LandModel; got {type(model).__name__}")
    soil = _soil_of(model)
    if soil.lateral_coupling is not None:
        raise ValueError(
            "the fused column kernel runs each column alone, so cross-column lateral "
            "coupling cannot run inside it: use the eager engine"
        )
    exchanged = exchanged_components(model)
    if exchanged:
        _check_surface(model, rain_forced)
    if len(soil.domain.batch_shape) != 1:
        raise ValueError(
            "the fused column kernel expects a 1-D column batch (nz, ncol); "
            f"got batch_shape={soil.domain.batch_shape}"
        )
    if not (_dynamic(soil, "energy") or _dynamic(soil, "hydrology")):
        raise ValueError("the fused kernel needs at least one dynamic component")
    for face, comp in BC_SLOTS:
        if face == "top" and comp in exchanged:
            continue
        face_bc = getattr(soil.boundary_conditions, face)
        if not isinstance(face_bc, SoilComponentBC):
            raise TypeError(f"unsupported {face} face BC {face_bc!r}")
        bc = getattr(face_bc, comp)
        if isinstance(bc, FreeDrainage) and comp == "energy":
            raise TypeError("FreeDrainage applies to the hydrology component only.")
        if not _dynamic(soil, comp):
            # a prescribed component has no flux: a flux value is ignored,
            # a Dirichlet value has no state to set (boundary.py raises)
            if isinstance(bc, (Dirichlet, FreeDrainage, BatchedBC)):
                raise TypeError(f"Unsupported BC {bc!r} for the prescribed {comp} component")
            continue
        if isinstance(bc, NoBC):
            raise ValueError(
                f"model with dynamic components requires a boundary condition "
                f"for {comp} at the {face} face (got NoBC)"
            )
        if type(bc) not in _BC_KIND:
            raise NotImplementedError(f"{type(bc).__name__} is not ported yet")


def _implied_policies(model, base):
    """The step-policy wrappers ``Simulation`` puts around ``base``, in the
    JAX kernel's order: the equilibrium projection inside, then lagged
    coefficients or, for a LandModel, the frozen exchange (which also lags
    its soil's coefficients) outside."""
    soil = _soil_of(model)
    st = wrap_stepper_with_projection(base, soil)
    if isinstance(model, LandModel):
        return wrap_stepper_for_land(st, model)
    return wrap_stepper_for_soil(st, model)


#: the step-policy bits of the mode word
_POLICY_BITS = MODE_LAGGED | MODE_FREEZE_RATE | MODE_FREEZE_EQ | MODE_NO_ICE
#: the policies the implicit kernel takes on the coupled branch, plain soil
#: or MOST top (B4 with B2, B3-rate, B3-eq, no ice, B2+B3-rate, B2+B3-eq and
#: B2 with no ice)
_IMPLICIT_POLICIES = frozenset({
    0, MODE_LAGGED, MODE_FREEZE_RATE, MODE_FREEZE_EQ, MODE_NO_ICE,
    MODE_LAGGED | MODE_FREEZE_RATE, MODE_LAGGED | MODE_FREEZE_EQ, MODE_LAGGED | MODE_NO_ICE,
})


def _check_stepper(model, stepper) -> None:
    """Refuse a stepper, or a combination with the model, that no kernel
    runs."""
    soil = _soil_of(model)
    base = _base_stepper(stepper)
    branch_only = not (_dynamic(soil, "energy") and _dynamic(soil, "hydrology"))
    # the kernel's step policies come from the model: a policy wrapper the
    # model does not call for would otherwise be dropped silently
    implied = _implied_policies(model, base)
    st = stepper
    while isinstance(st, _POLICY_STEPPERS):
        if not _chain_contains(implied, type(st)):
            raise ValueError(
                f"{type(st).__name__} in the stepper, but the model's "
                "coefficient_update / freeze_thaw / surface_update do not call for it"
            )
        st = st.inner
    if type(base) in _EXPLICIT_STEPPERS:
        return
    if type(base) not in _STEPPER_BITS:
        raise NotImplementedError(
            "the fused kernels step with ForwardEuler, SSPRK22, SSPRK33, SSPRK104 and the implicit "
            f"steppers; {type(base).__name__} has no kernel"
        )
    if isinstance(model, LandModel):
        raise NotImplementedError(
            "the implicit steppers with a LandModel have no kernel, and the reference kernel cannot run "
            "them either: JAX's implicit steppers return the soil state alone, dropping the pond that "
            "its kernel body then reads (ROADMAP B4)"
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
    policies = kernel_mode(model, base) & _POLICY_BITS
    if policies and not _dynamic(model, "hydrology"):
        raise NotImplementedError(
            "the implicit steppers with lagged coefficients or assume_no_ice on the heat-only branch have "
            "no kernel, and the reference kernel cannot run them either: JAX's implicit heat sweep reads "
            "theta_i from a state that holds none (imex.py:231, KeyError 'theta_i'; ROADMAP B4)"
        )
    if policies not in _IMPLICIT_POLICIES:
        raise NotImplementedError(
            f"the implicit kernel mode {mode_name(kernel_mode(model, base))} is not ported yet (ROADMAP B4): "
            "the kernel takes lagged coefficients alone or with either freeze-thaw scheme or "
            "assume_no_ice, and either scheme or assume_no_ice alone"
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
    **in place** (see :class:`FusedColumnRun`).  ``model`` is a
    ``SoilModel`` or a ``LandModel``; ``stepper`` is an explicit stepper
    (ForwardEuler, SSPRK22, SSPRK33, SSPRK104), bare or in the
    step-policy wrappers ``Simulation`` puts around it, or one of the
    implicit steppers built with this ``model``; the kernel's mode follows
    the model and the stepper (:func:`kernel_mode`).  ``tile_cols`` is the
    number of columns (threads) per CUDA block, a multiple of 32 up to 1024;
    ``ncol`` need not be a multiple of it; in the column-tile kernel's modes
    (:data:`TILE_MODES`: ``B1+kinds+B8`` and ``B1-no-ice+kinds+B8`` under
    any explicit stepper) a block of 256 threads holds a tile of at most
    ``tile_cols`` columns, each column's levels spread over level lanes:
    :func:`tile_plan` picks the tile from ``nz`` (at most 32 columns at
    nz=48, so the default does not bind there).  Time advances
    ``steps_per_call * dt`` per call.

    ``streamed_geometry``: an optional ``(dz, zc)`` pair of ``(ncol,)`` and
    ``(nz, ncol)`` tensors, a per-column grid that replaces the model's
    (kernel mode B8; the model's domain gives ``nz`` and the flat batch).
    The kernel reads them where they are, on the launch's device.

    ``forcing_fields``: names of forcing fields streamed through the kernel
    (kernel B7; the routing of ``runtime/forcing_driver.py``: the
    ``PrescribedAtmosForcing`` fields and/or ``"precipitation"``):
    ``run(Y, t0, forcing)`` then takes a dict of ``(steps_per_call,)`` (one
    value per step) or ``(steps_per_call, ncol)`` (per column) rows, row
    ``i`` replacing the field for all stages of in-kernel step ``i``.  With
    ``forcing_time_grid = (t_start, dt_forcing, n_rows)`` the rows are a
    table of ``n_rows`` and each step reads the row of its start time ``t``,
    ``clip(trunc((t - t_start) * (1 / dt_forcing)), 0, n_rows - 1)``.  The
    rows stay where they are (no copy per launch on the card); the fields
    not streamed keep their stage tables.

    ``differentiable=True`` returns a :class:`DifferentiableFusedRun`
    (kernel mode B9) of the plain soil column: ``run(Y, t0, dt_run=None)``
    returns a new state that ``torch.autograd`` differentiates in ``Y``,
    ``t0`` and ``dt_run``; a LandModel, ``forcing_fields`` and
    ``streamed_geometry`` raise ``NotImplementedError``, as in JAX."""
    forcing_fields = tuple(forcing_fields)
    if differentiable:
        from landhydrology_tpu_torch.ops.cuda.differentiable import check_scope

        check_scope(model, forcing_fields, streamed_geometry)
    rain_forced = False
    if forcing_fields:
        rain_forced = _split_routing(model, forcing_fields)[1]
    if forcing_time_grid is not None:
        if not forcing_fields:
            raise ValueError("forcing_time_grid requires forcing_fields to stream")
        t_start, dt_forcing, n_rows = forcing_time_grid
        if int(n_rows) < 1 or float(dt_forcing) <= 0.0:
            raise ValueError(
                f"forcing_time_grid needs n_rows >= 1 and dt_forcing > 0; got {forcing_time_grid}"
            )
        forcing_time_grid = (float(t_start), float(dt_forcing), int(n_rows))
    _check_model(model, rain_forced)
    _check_stepper(model, stepper)
    _check_per_column(model, stepper, streamed_geometry, forcing_fields)
    if streamed_geometry is not None:
        streamed_geometry = _check_geometry(model, streamed_geometry)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1; got {steps_per_call}")
    if tile_cols < 32 or tile_cols > 1024 or tile_cols % 32:
        raise ValueError(
            f"tile_cols must be a multiple of 32 in [32, 1024]; got {tile_cols}"
        )
    run = FusedColumnRun(model, stepper, dt, steps_per_call, tile_cols, forcing_fields, forcing_time_grid,
                         streamed_geometry)
    if differentiable:
        from landhydrology_tpu_torch.ops.cuda.differentiable import DifferentiableFusedRun

        return DifferentiableFusedRun(run)
    return run


def _check_geometry(model, geometry) -> tuple:
    """``streamed_geometry`` as ``(dz, zc)`` tensors of the model dtype:
    ``(ncol,)`` and ``(nz, ncol)`` for the model's ``nz`` and flat batch."""
    soil = _soil_of(model)
    dz, zc = geometry
    if not (torch.is_tensor(dz) and torch.is_tensor(zc)):
        raise TypeError("streamed_geometry must be a (dz, zc) pair of tensors")
    ncol = soil.domain.batch_shape[0]
    nz = soil.domain.nelements
    if tuple(dz.shape) != (ncol,) or tuple(zc.shape) != (nz, ncol):
        raise ValueError(
            f"streamed_geometry has shapes dz {tuple(dz.shape)}, zc {tuple(zc.shape)}; expected "
            f"({ncol},) and ({nz}, {ncol})"
        )
    dtype = soil.float_dtype
    return dz.to(dtype), zc.to(dtype)
