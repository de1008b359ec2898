"""Fused multi-step column kernel (CUDA, Hopper) and its plain version.

Replaces ``landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run``
in its explicit SSPRK33 modes: ``steps_per_call`` SSPRK33 steps of the
coupled water + energy tendency per launch, updating the state in place.
The CUDA source is ``csrc/column_kernel.cu``; it is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use
and bound with ``ctypes``.

- One thread owns one column and sweeps its levels; the grid is
  ``ceil(ncol / tile_cols)`` blocks of ``tile_cols`` threads, with the ragged
  last block masked, so ``ncol`` need not be a multiple of the tile.
- The model selects the kernel's mode (:func:`kernel_mode`), a template
  instance of the source: stage coefficients (B1) or lagged ones
  (``coefficient_update="step"``, B2), with ``assume_no_ice``, or with
  freeze-thaw rate sources or the equilibrium projection (B3).
- Per-column parameters arrive as a pointer plus a column stride (0 for a
  scalar).  Column constants the closures derive from the parameters
  (``m``, ``alpha**-n``, ``k_dry``, the Kersten exponents, ...) are
  evaluated here, by the same expressions the eager closures use.
- A CUDA kernel cannot call a Python BC value such as
  ``Dirichlet(lambda t: 0.31)``: every BC value is evaluated on the host into
  a table over (step, stage), at the kernel's own stage times
  ``t = t0 + i*dt`` and ``t, t + dt, t + dt/2``, in the model dtype.

The plain version, :func:`fused_column_run_plain`, is the same number of
eager ``stepper.step`` calls, with the model's step policies wrapped around
SSPRK33 as ``Simulation`` wraps them.  A run on CPU tensors uses it; a run on
CUDA tensors launches the kernel or raises.

Modes of the JAX factory not ported yet raise ``NotImplementedError`` on
either device: non-SSPRK33 and implicit steppers (B4), MOST (B5, at BC
construction), the LandModel pond (B6), streamed forcing (B7), streamed
geometry (B8) and ``differentiable=True`` (B9); so do the water-only and
heat-only branches.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models.soil import heat as sh
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    EquilibriumFreezeThaw,
    FreezeThaw,
    PhaseEquilibriumStepper,
    wrap_stepper_with_projection,
)
from landhydrology_tpu_torch.models.soil.lagged import (
    LaggedCoefficientStepper,
    _chain_contains,
    wrap_stepper_for_soil,
)
from landhydrology_tpu_torch.models.soil.boundary import (
    Dirichlet,
    FreeDrainage,
    NoBC,
    SoilComponentBC,
    VerticalFlux,
)
from landhydrology_tpu_torch.models.soil.model import (
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
SOURCE = _PACKAGE / "csrc" / "column_kernel.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per-column kernel inputs, in the order of ``enum Param`` in the source
PARAM_NAMES = (
    "nu", "S_s", "rho_c_ds", "theta_r", "Ksat", "m", "inv_m", "neg_inv_m",
    "inv_n", "alpha_pow_neg_n", "ln_kappa_sat_unfrozen", "ln_kappa_sat_frozen",
    "kappa_dry", "neg_b", "kersten_exp_unfrozen", "kersten_exp_bracket",
    "kersten_exp_frozen", "visc_gamma", "visc_T_ref", "impedance_coef",
    "kappa_sat_unfrozen", "alpha", "n", "tau",
)
#: (face, component) of each BC slot, in the order of ``enum BCSlot``
BC_SLOTS = (
    ("bottom", "energy"), ("bottom", "hydrology"),
    ("top", "energy"), ("top", "hydrology"),
)
_BC_KIND = {VerticalFlux: 1, Dirichlet: 2, FreeDrainage: 3}
_STAGES = 3  # SSPRK33
_FN_NAMES = {torch.float32: "column_kernel_ssprk33_f32",
             torch.float64: "column_kernel_ssprk33_f64"}

#: bits of the kernel's mode word, as ``enum Mode`` in the source
MODE_LAGGED, MODE_FREEZE_RATE, MODE_FREEZE_EQ, MODE_NO_ICE = 1, 2, 4, 8

_P = len(PARAM_NAMES)
_B = len(BC_SLOTS)


class _KernelArgs(ctypes.Structure):
    """Mirror of ``struct KernelArgs`` in the CUDA source (8-byte fields)."""

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


def build_library() -> Path:
    """Compile the kernel source into ``_build/`` (once per source and flag
    set; concurrent processes serialize on a lock file and publish the
    library by atomic rename).  ptxas's report (registers and spills of each
    template instance) is kept beside it as ``<library>.ptxas.txt``.
    Returns the library's path."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"column_kernel_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
    return lib


_library = None


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.column_kernel_args_size.restype = ctypes.c_int
        lib.column_kernel_args_size.argtypes = []
        size = lib.column_kernel_args_size()
        if size != ctypes.sizeof(_KernelArgs):
            raise RuntimeError(
                f"KernelArgs is {size} bytes in the library but "
                f"{ctypes.sizeof(_KernelArgs)} in Python"
            )
        for name in _FN_NAMES.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(_KernelArgs), ctypes.c_int, ctypes.c_void_p,
            ]
        _library = lib
    return _library


#: launches of the column kernel by every run in this process, per mode
#: (:func:`mode_name`); a caller may clear it and read it back around a run
LAUNCHES: collections.Counter = collections.Counter()


def kernel_mode(model: SoilModel) -> int:
    """The kernel's mode word for ``model``: ``MODE_*`` bits."""
    mode = MODE_LAGGED if model.coefficient_update == "step" else 0
    if isinstance(model.freeze_thaw, FreezeThaw):
        mode |= MODE_FREEZE_RATE
    elif isinstance(model.freeze_thaw, EquilibriumFreezeThaw):
        mode |= MODE_FREEZE_EQ
    if model.assume_no_ice:
        mode |= MODE_NO_ICE
    return mode


def mode_name(mode: int) -> str:
    """The kernel table's name of a mode: ``B1`` (stage coefficients) or
    ``B2`` (lagged), ``-no-ice`` for ``assume_no_ice``, and ``B3-rate`` /
    ``B3-eq`` for freeze-thaw (``B2+B3-rate`` with lagged coefficients)."""
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
    """Scratch values per cell: the two SSPRK33 stage states, and with
    lagged coefficients K, kappa, 1/rho_c_s, rho_e_int_l K (and rho_c_s for
    the rate sources)."""
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
    hm = hydrology.hydraulic_model
    m = hm.m
    e_unf, e_bracket, e_fr = sh.kersten_exponents(sp)
    visc = hydrology.viscosity_factor
    imp = hydrology.impedance_factor
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


def bc_value_table(value, t0, dt, n_steps: int, ncol: int, dtype, device):
    """A BC value as ``(table, row stride, column stride)``: row
    ``3*i + s`` holds the value at stage ``s`` of step ``i`` (stage times
    ``t, t + dt, t + dt/2``).  A constant has row stride 0, a per-column
    value column stride 1."""
    if not callable(value):
        table, col_stride = _column_tensor(value, ncol, dtype, device, "BC value")
        return table, 0, col_stride
    dt_t = torch.as_tensor(dt, dtype=dtype)
    rows = []
    for t in step_times(t0, dt, n_steps, dtype):
        for ts in (t, t + dt_t, t + 0.5 * dt_t):
            rows.append(torch.as_tensor(value(ts), dtype=dtype).cpu())
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


def bc_tables(
    model: SoilModel, t0, dt, n_steps: int, ncol: int, device, reuse=None
) -> list:
    """:func:`bc_value_table` of each BC slot (``None`` for free drainage,
    which has no value).  Where ``reuse`` is given, the tables of values
    that do not depend on time are taken from it and only the callable
    values are evaluated."""
    tables = []
    for j, (face, comp) in enumerate(BC_SLOTS):
        bc = _bc_of(model, face, comp)
        if isinstance(bc, FreeDrainage):
            tables.append(None)
            continue
        value = bc.flux if isinstance(bc, VerticalFlux) else bc.state_value
        if reuse is not None and not callable(value):
            tables.append(reuse[j])
        else:
            tables.append(
                bc_value_table(value, t0, dt, n_steps, ncol, model.float_dtype, device)
            )
    return tables


# --------------------------------------------------------------------------
# Plain version and the run object
# --------------------------------------------------------------------------


_POLICY_STEPPERS = (LaggedCoefficientStepper, PhaseEquilibriumStepper)


def _base_stepper(stepper):
    """``stepper`` without the step-policy wrappers the model implies."""
    while isinstance(stepper, _POLICY_STEPPERS):
        stepper = stepper.inner
    return stepper


def fused_column_run_plain(
    model: SoilModel, stepper: AbstractTimestepper, dt, steps_per_call: int, Y: dict, t0
) -> dict:
    """The plain PyTorch version of one kernel launch: ``steps_per_call``
    eager ``stepper.step(make_rhs(model))`` calls from ``t0``, with the
    model's step policies wrapped around ``stepper`` as ``Simulation`` wraps
    them (projection inside, lagged coefficients outside).  Returns a new
    state and leaves ``Y`` as it was."""
    dtype = model.float_dtype
    device = Y[model.name]["vartheta_l"].device
    grid = make_function_space(model.domain, dtype, device)
    rhs = make_rhs(model, grid)
    stepper = wrap_stepper_with_projection(_base_stepper(stepper), model)
    stepper = wrap_stepper_for_soil(stepper, model, grid)
    Ya = {"zc": grid.zc, model.name: {}}
    dt_t = torch.as_tensor(dt, dtype=dtype)
    for t in step_times(t0, dt, steps_per_call, dtype):
        Y = stepper.step(rhs, Y, Ya, t, dt_t)
    return Y


class FusedColumnRun:
    """``run(Y, t0) -> Y``: advance ``steps_per_call`` SSPRK33 steps from
    ``t0``, **in place**: the tensors of ``Y`` are overwritten and ``Y`` is
    returned.  CUDA tensors go through the kernel (or the call raises); CPU
    tensors through :func:`fused_column_run_plain`.  Each launch adds one
    to the module's ``LAUNCHES`` under the name of its mode."""

    def __init__(self, model: SoilModel, dt: float, steps_per_call: int, tile_cols: int):
        self.model = model
        self.dt = float(dt)
        self.steps_per_call = int(steps_per_call)
        self.tile_cols = int(tile_cols)
        self.mode = kernel_mode(model)
        self._device_inputs = {}  # (device, ncol) -> (params, zc, dz, BC tables)

    def __call__(self, Y: dict, t0) -> dict:
        model = self.model
        fields = [Y[model.name][k] for k in ("vartheta_l", "theta_i", "rho_e_int")]
        device = fields[0].device
        if device.type == "cpu":
            Yn = fused_column_run_plain(
                model, SSPRK33(), self.dt, self.steps_per_call, Y, t0
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
        column count; the tables of callable BC values are rebuilt per
        launch."""
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
            tables = bc_tables(model, 0.0, self.dt, self.steps_per_call, ncol, device)
            self._device_inputs[key] = (
                params, grid.zc.reshape(-1).contiguous(), grid.dz, tables
            )
        return self._device_inputs[key]

    def _launch(self, fields, t0, device):
        model = self.model
        dtype = model.float_dtype
        nz, ncol = fields[0].shape
        params, zc, dz, constant_tables = self._inputs(ncol, device)
        tables = bc_tables(
            model, t0, self.dt, self.steps_per_call, ncol, device, reuse=constant_tables
        )
        scratch = torch.empty(scratch_fields(self.mode) * nz * ncol, dtype=dtype, device=device)
        args = kernel_args(
            model, fields, scratch, zc, dz, params, tables, self.steps_per_call, self.dt
        )
        lib = load_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, _FN_NAMES[dtype])(
                ctypes.byref(args), self.tile_cols, ctypes.c_void_p(stream)
            )
        if rc != 0:
            raise RuntimeError(f"column kernel launch failed: cudaError {rc}")
        LAUNCHES[mode_name(self.mode)] += 1


def kernel_args(model, fields, scratch, zc, dz, params, tables, n_steps, dt) -> _KernelArgs:
    """Pack the kernel's argument struct.  The caller keeps every tensor
    alive until the launch has been queued."""
    nz, ncol = fields[0].shape
    ps = model.earth_param_set
    hydrology = model.hydrology_model
    a = _KernelArgs()
    a.vartheta_l, a.theta_i, a.rho_e_int = (f.data_ptr() for f in fields)
    a.scratch = scratch.data_ptr()
    a.zc = zc.data_ptr()
    for j, (t, stride) in enumerate(params):
        a.param_ptr[j] = t.data_ptr()
        a.param_stride[j] = stride
    for j, ((face, comp), table) in enumerate(zip(BC_SLOTS, tables)):
        a.bc_kind[j] = _BC_KIND[type(_bc_of(model, face, comp))]
        if table is not None:
            a.bc_ptr[j] = table[0].data_ptr()
            a.bc_row_stride[j] = table[1]
            a.bc_col_stride[j] = table[2]
    a.nz, a.ncol, a.n_steps = nz, ncol, n_steps
    a.viscosity = int(isinstance(hydrology.viscosity_factor, TemperatureDependentViscosity))
    a.impedance = int(isinstance(hydrology.impedance_factor, IceImpedance))
    a.mode = kernel_mode(model)
    ft = model.freeze_thaw
    if isinstance(ft, EquilibriumFreezeThaw):
        a.n_iter, a.T_lo, a.T_hi = int(ft.n_iter), float(ft.T_lo), float(ft.T_hi)
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
    if not (
        isinstance(model.energy_model, SoilEnergyModel)
        and isinstance(model.hydrology_model, SoilHydrologyModel)
    ):
        raise NotImplementedError(
            "the fused kernel runs the coupled (SoilEnergyModel, "
            "SoilHydrologyModel) branch only; the water-only and heat-only "
            "branches of kernel B1 are not ported yet (ROADMAP B1)"
        )
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
        if isinstance(bc, NoBC):
            raise ValueError(
                f"model with dynamic components requires a boundary condition "
                f"for {comp} at the {face} face (got NoBC)"
            )
        if isinstance(bc, FreeDrainage) and comp == "energy":
            raise TypeError("FreeDrainage applies to the hydrology component only.")
        if type(bc) not in _BC_KIND:
            raise NotImplementedError(f"{type(bc).__name__} is not ported yet")


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
    """Build ``run(Y, t0) -> Y`` advancing ``steps_per_call`` SSPRK33 steps
    per call **in place** (see :class:`FusedColumnRun`).  The kernel's mode
    follows the model (:func:`kernel_mode`); ``stepper`` is SSPRK33, bare or
    in the step-policy wrappers ``Simulation`` puts around it.  ``tile_cols`` is
    the number of columns (threads) per CUDA block, a multiple of 32 up to
    1024; ``ncol`` need not be a multiple of it.  Time advances
    ``steps_per_call * dt`` per call."""
    _check_model(model)
    base = _base_stepper(stepper)
    if type(base) is not SSPRK33:
        raise NotImplementedError(
            f"the fused kernel steps with SSPRK33 only; {type(base).__name__} "
            "is not ported (implicit steps are kernel B4, ROADMAP A10)"
        )
    # the kernel's step policies come from the model: a policy wrapper the
    # model does not call for would otherwise be dropped silently
    implied = wrap_stepper_for_soil(wrap_stepper_with_projection(base, model), model)
    st = stepper
    while isinstance(st, _POLICY_STEPPERS):
        if not _chain_contains(implied, type(st)):
            raise ValueError(
                f"{type(st).__name__} in the stepper, but the model's "
                "coefficient_update / freeze_thaw do not call for it"
            )
        st = st.inner
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
    return FusedColumnRun(model, dt, steps_per_call, tile_cols)
