"""Carry models, steppers and states over from the JAX package.

``model_from_reference`` builds this package's :class:`SoilModel` or
:class:`LandModel` from the ``landhydrology_tpu`` one, and ``stepper_from_reference`` an
implicit stepper from the JAX package's; ``state_from_numpy`` and
``forcing_from_numpy`` carry states and forcing tables.  It reads the reference's frozen
dataclasses by class name and ``dataclasses.fields``, and each array leaf
through ``np.asarray``, so it needs no JAX import.  Array leaves become
tensors of the model's dtype, but for ``BatchedBC.kind``, which stays an
integer tensor, and a ``VariableDepthColumn``'s depths, which stay float64
host arrays.  User callables (BC values, profiles) are carried over as they
are and must accept tensors; the reference's own default profiles are
replaced by this package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from landhydrology_tpu_torch.constants import EarthParameterSet
from landhydrology_tpu_torch.domains import Column, VariableDepthColumn, make_function_space
from landhydrology_tpu_torch.imex import IMPLICIT_STEPPERS
from landhydrology_tpu_torch.models.land import (
    ConstantPrecipitation,
    KinematicWaveRouting,
    LandModel,
    PulsePrecipitation,
    RunoffRouting,
    SurfaceWaterModel,
)
from landhydrology_tpu_torch.models.soil.freeze_thaw import (
    EquilibriumFreezeThaw,
    FreezeThaw,
)
from landhydrology_tpu_torch.models.soil.boundary import (
    BatchedBC,
    Dirichlet,
    FreeDrainage,
    NoBC,
    PrescribedAtmosForcing,
    SoilColumnBC,
    SoilComponentBC,
    VerticalFlux,
)
from landhydrology_tpu_torch.models.soil.model import (
    LateralSurfaceCoupling,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
)
from landhydrology_tpu_torch.models.soil.params import SoilParams
from landhydrology_tpu_torch.models.soil.water import (
    IceImpedance,
    NoEffect,
    TemperatureDependentViscosity,
    vanGenuchten,
)

_PORTED = {
    cls.__name__: cls
    for cls in (
        EarthParameterSet, Column, VariableDepthColumn, SoilParams,
        vanGenuchten, NoEffect, TemperatureDependentViscosity, IceImpedance, SoilEnergyModel,
        SoilHydrologyModel, PrescribedTemperatureModel,
        PrescribedHydrologyModel, SoilModel, LateralSurfaceCoupling, NoBC, VerticalFlux, Dirichlet,
        FreeDrainage, SoilComponentBC, SoilColumnBC, BatchedBC,
        PrescribedAtmosForcing, FreezeThaw, EquilibriumFreezeThaw, LandModel,
        SurfaceWaterModel, ConstantPrecipitation, PulsePrecipitation,
        RunoffRouting, KinematicWaveRouting,
    )
}
_REFERENCE_PACKAGE = "landhydrology_tpu."


def _convert(obj, device, dtype):
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _PORTED.get(type(obj).__name__)
        if cls is None:
            raise NotImplementedError(f"{type(obj).__name__} is not ported yet")
        port_fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for f in dataclasses.fields(obj):
            if cls is SoilModel and f.name == "dtype":
                continue
            value = getattr(obj, f.name)
            if cls is VariableDepthColumn and f.name in ("z_bottom", "z_top"):
                kwargs[f.name] = np.array(value, dtype=np.float64)  # never the model dtype
            elif cls is BatchedBC and f.name == "kind":
                kwargs[f.name] = _integer_leaf(value, device)
            elif dataclasses.is_dataclass(value):
                kwargs[f.name] = _convert(value, device, dtype)
            elif callable(value) and getattr(value, "__module__", "").startswith(
                _REFERENCE_PACKAGE
            ):
                kwargs[f.name] = port_fields[f.name].default  # default profile
            else:
                kwargs[f.name] = _convert(value, device, dtype)
        if cls is SoilModel:
            kwargs.update(dtype=dtype, device=device)
        return cls(**kwargs)
    if callable(obj):
        return obj
    arr = np.array(obj)  # a writable copy
    if arr.ndim == 0:
        return arr.item()
    return torch.as_tensor(arr, dtype=dtype, device=device)


def _integer_leaf(value, device):
    """An integer array leaf (``BatchedBC`` kind codes) as an integer tensor
    of the same dtype on ``device``, or a Python int."""
    arr = np.array(value)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"BatchedBC.kind must hold integer codes; got dtype {arr.dtype}")
    return int(arr) if arr.ndim == 0 else torch.as_tensor(arr, device=device)


def model_from_reference(ref_model, device="cuda", dtype=torch.float64):
    """This package's model equivalent to the JAX package's ``ref_model``
    (a ``SoilModel`` or a ``LandModel``), with its tensors in ``dtype`` on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""
    return _convert(ref_model, device, dtype)


def stepper_from_reference(ref_stepper, model: SoilModel, device=None):
    """This package's implicit stepper of the JAX package's ``ref_stepper``
    class name (``TRBDF2Soil``, ``BackwardEulerRichards``,
    ``BackwardEulerSoil``), for ``model`` (this package's, e.g. from
    :func:`model_from_reference`): ``iters`` and ``tridiag`` are carried
    over, the grid is rebuilt on ``device``, by default the model's."""
    cls = {c.__name__: c for c in IMPLICIT_STEPPERS}.get(type(ref_stepper).__name__)
    if cls is None:
        raise NotImplementedError(f"{type(ref_stepper).__name__} is not ported yet")
    device = model.device if device is None else device
    grid = make_function_space(model.domain, model.float_dtype, device)
    return cls(model=model, grid=grid, iters=int(ref_stepper.iters), tridiag=ref_stepper.tridiag)


def state_from_numpy(Y: dict, device="cuda", dtype=torch.float64) -> dict:
    """A nested state dict of array-likes as contiguous tensors on ``device``
    (the card unless the caller asks for ``"cpu"``)."""
    if isinstance(Y, dict):
        return {k: state_from_numpy(v, device, dtype) for k, v in Y.items()}
    return torch.as_tensor(np.array(Y), dtype=dtype, device=device).contiguous()


def forcing_from_numpy(rows: dict, device="cuda", dtype=torch.float64) -> dict:
    """A dict of forcing rows (``(n_steps,)`` or ``(n_steps, ncol)``
    array-likes, e.g. the JAX package's forcing tables) as contiguous
    tensors in ``dtype`` on ``device`` (the card unless the caller asks for
    ``"cpu"``), ready for ``make_forced_segment_run`` and the fused run."""
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device).contiguous() for k, v in rows.items()}


def state_to_numpy(Y: dict) -> dict:
    """A nested state dict of tensors as numpy arrays."""
    if isinstance(Y, dict):
        return {k: state_to_numpy(v) for k, v in Y.items()}
    return Y.detach().cpu().numpy()
