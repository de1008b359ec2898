"""Config serialization for the model lattice.

PyTorch port of ``landhydrology_tpu/config.py``, on the same JSON format, so
a run file written by either package builds the same model in both:

    cfg = to_config(model)                    # nested {"__type__": ..., fields...}
    model = from_config(cfg, device="cuda")   # the dataclass lattice, on the card

``to_config`` of a port model equals the JAX package's ``to_config`` of the
same model: the dtype is ``{"__dtype__": "float64"}``, tensors are
``{"__array__": [...], "dtype": ...}`` (copied to the host), and a
``SoilModel``'s ``device`` is not written (the run chooses it).
``from_config(cfg, device=...)`` puts every array on ``device`` and gives
each ``SoilModel`` that device; a ``SoilModel`` of ``"dtype": null`` (the
JAX package's default float, float64 with x64) takes ``torch.float64``.
Callables (profiles, time-dependent BC values) are not serializable and
raise ``TypeError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from landhydrology_tpu_torch.constants import EarthParameterSet
from landhydrology_tpu_torch.domains import Column, VariableDepthColumn
from landhydrology_tpu_torch.models.land import (
    ConstantPrecipitation,
    KinematicWaveRouting,
    LandModel,
    PulsePrecipitation,
    RunoffRouting,
    SurfaceWaterModel,
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
from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
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

_REGISTRY = {
    cls.__name__: cls
    for cls in [
        Column,
        VariableDepthColumn,
        EarthParameterSet,
        SoilParams,
        vanGenuchten,
        NoEffect,
        TemperatureDependentViscosity,
        IceImpedance,
        SoilEnergyModel,
        SoilHydrologyModel,
        PrescribedTemperatureModel,
        PrescribedHydrologyModel,
        SoilModel,
        LateralSurfaceCoupling,
        FreezeThaw,
        EquilibriumFreezeThaw,
        NoBC,
        VerticalFlux,
        Dirichlet,
        FreeDrainage,
        SoilComponentBC,
        SoilColumnBC,
        PrescribedAtmosForcing,
        BatchedBC,
        LandModel,
        SurfaceWaterModel,
        RunoffRouting,
        KinematicWaveRouting,
        ConstantPrecipitation,
        PulsePrecipitation,
    ]
}


def to_config(obj: Any) -> Any:
    """Dataclass lattice -> JSON-able nested dict, as the JAX package's."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__type__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            if not (f.name == "device" and isinstance(obj, SoilModel)):  # the run chooses the device
                out[f.name] = to_config(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_config(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_config(v) for k, v in obj.items()}
    if isinstance(obj, torch.dtype):
        return {"__dtype__": str(obj).replace("torch.", "")}
    if isinstance(obj, type):
        try:
            return {"__dtype__": str(np.dtype(obj))}
        except TypeError:
            raise TypeError(f"cannot serialize type {obj!r}")
    if torch.is_tensor(obj):
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "__array__"):
        arr = np.asarray(obj)
        return {"__array__": arr.tolist(), "dtype": str(arr.dtype)}
    if callable(obj):
        raise TypeError(
            f"cannot serialize callable {obj!r}: time/space-dependent "
            "profiles belong in scripts, not configs"
        )
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    raise TypeError(f"cannot serialize {type(obj).__name__}: {obj!r}")


def from_config(cfg: Any, device="cuda") -> Any:
    """Nested dict -> dataclass lattice (inverse of :func:`to_config`), its
    arrays and models on ``device``."""
    if isinstance(cfg, dict) and "__type__" in cfg:
        cls = _REGISTRY.get(cfg["__type__"])
        if cls is None:
            raise KeyError(f"unknown config type {cfg['__type__']!r}")
        kwargs = {k: from_config(v, device) for k, v in cfg.items() if k != "__type__"}
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(kwargs) - field_names
        if unknown:
            raise KeyError(f"{cfg['__type__']}: unknown fields {sorted(unknown)}")
        if cls is SoilModel:
            kwargs["device"] = device
            if kwargs.get("dtype", torch.float64) is None:
                kwargs["dtype"] = torch.float64
        return cls(**kwargs)
    if isinstance(cfg, dict) and "__dtype__" in cfg:
        return getattr(torch, np.dtype(cfg["__dtype__"]).name)
    if isinstance(cfg, dict) and "__array__" in cfg:
        return torch.as_tensor(np.asarray(cfg["__array__"], dtype=cfg["dtype"]), device=device)
    if isinstance(cfg, list):
        return tuple(from_config(v, device) for v in cfg)
    if isinstance(cfg, dict):
        return {k: from_config(v, device) for k, v in cfg.items()}
    return cfg
