"""landhydrology_tpu_torch — the PyTorch + CUDA port of landhydrology_tpu.

A batched 1-D soil-column solver for coupled water (Richards equation) and
energy (heat equation) transport.  State tensors are ``(nz, *batch)`` with
the columns contiguous; the explicit hot path (SSPRK33, and ForwardEuler,
SSPRK22, SSPRK104) runs in one hand-written CUDA kernel per
``steps_per_call`` steps (``ops/cuda/column_kernel.py``, engine
``"fused"``), and so do the implicit
steppers of ``imex.py`` (TR-BDF2 and backward Euler with a tridiagonal solve
in each column), and so do a MOST top face and the LandModel pond
(``models/land.py``); every function also runs eagerly on CPU or GPU
tensors (engine ``"torch"``).

Forced runs (``runtime/``): per-column atmosphere and rain rows written with
``write_forcing`` stream from the native reader through ``run_forced`` into
``make_forced_segment_run`` (engine ``"torch"``, or ``"fused"``: the rows
read per step inside the land kernel); ``convert.forcing_from_numpy``
carries forcing tables over as ``convert.state_from_numpy`` carries states.

Heterogeneous grids: per-column BC kinds (``BatchedBC``, ``BCKind``) and
depths (``VariableDepthColumn``) run on both engines (kernel modes
B1-batched and B8); ``LateralSurfaceCoupling`` on an ``(nx, ny)`` batch on
the eager engine.

JSON run files of the JAX package run through ``python -m
landhydrology_tpu_torch run run.json`` (``cli.py``; ``config.py``'s
``to_config`` / ``from_config`` and ``checkpoint.py``'s
``CheckpointManager`` in the JAX package's ``.npz`` layout).

The public API mirrors ``landhydrology_tpu``'s, minus what is not ported yet
(see ROADMAP.md).  This package imports neither JAX nor landhydrology_tpu.
"""

from landhydrology_tpu_torch.constants import EarthParameterSet, default_earth_param_set
from landhydrology_tpu_torch.domains import (
    Column,
    ColumnGrid,
    VariableDepthColumn,
    make_function_space,
)
from landhydrology_tpu_torch.imex import BackwardEulerRichards, BackwardEulerSoil, TRBDF2Soil
from landhydrology_tpu_torch.models.soil import (
    BatchedBC,
    BCKind,
    Dirichlet,
    FreeDrainage,
    LateralSurfaceCoupling,
    NoBC,
    PrescribedAtmosForcing,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
    boundary_fluxes,
    compute_turbulent_surface_fluxes,
    default_initial_conditions,
    initialize_auxiliary,
    initialize_prognostic,
    initialize_states,
    make_rhs,
    make_update_aux,
)
from landhydrology_tpu_torch.simulations import Simulation, run, step

__version__ = "0.1.0"

__all__ = [
    "EarthParameterSet",
    "default_earth_param_set",
    "Column",
    "ColumnGrid",
    "VariableDepthColumn",
    "make_function_space",
    "SoilParams",
    "SoilModel",
    "SoilEnergyModel",
    "SoilHydrologyModel",
    "PrescribedTemperatureModel",
    "PrescribedHydrologyModel",
    "NoBC",
    "BatchedBC",
    "BCKind",
    "LateralSurfaceCoupling",
    "VerticalFlux",
    "Dirichlet",
    "FreeDrainage",
    "SoilComponentBC",
    "SoilColumnBC",
    "PrescribedAtmosForcing",
    "boundary_fluxes",
    "compute_turbulent_surface_fluxes",
    "make_rhs",
    "make_update_aux",
    "initialize_states",
    "initialize_prognostic",
    "initialize_auxiliary",
    "default_initial_conditions",
    "BackwardEulerRichards",
    "BackwardEulerSoil",
    "TRBDF2Soil",
    "Simulation",
    "run",
    "step",
]
