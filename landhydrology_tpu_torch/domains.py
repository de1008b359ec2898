"""Domains: the 1-D vertical soil column, batched.

PyTorch port of ``landhydrology_tpu/domains.py``.  Fields carry shape
``(nz, *batch_shape)``: the vertical axis leads and columns trail, so a
level of a column batch is contiguous in memory.  Coordinate tensors have
shape ``(nz, *[1]*len(batch_shape))`` so they broadcast against any batch.
``VariableDepthColumn`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class Column:
    """A 1-D vertical column domain: ``zlim = (zmin, zmax)``, ``nelements``
    uniform cells, and an optional trailing ``batch_shape`` of independent
    columns."""

    zlim: Tuple[float, float]
    nelements: int
    batch_shape: Tuple[int, ...] = ()
    boundary_tags: Tuple[str, str] = ("bottom", "top")

    def __post_init__(self):
        if not self.zlim[0] < self.zlim[1]:
            raise ValueError(f"zlim must satisfy zmin < zmax, got {self.zlim}")

    @property
    def ndims(self) -> int:
        return 1

    def __len__(self) -> int:  # reference Base.length = physical height
        return int(self.zlim[1] - self.zlim[0])

    @property
    def height(self) -> float:
        return self.zlim[1] - self.zlim[0]

    @property
    def size(self) -> float:
        return self.height

    def __repr__(self) -> str:
        return f"[{self.zlim[0]:0.1f}, {self.zlim[1]:0.1f}]"


@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """Discretized column: ``zc`` ``(nz, *ones)`` and ``zf`` ``(nz+1, *ones)``
    coordinate tensors, and the cell spacing ``dz`` as a Python float that is
    exactly representable in the grid's dtype.

    ``dz_boundary = dz/2`` is the half-cell center-to-face distance used in
    every Dirichlet-to-flux conversion."""

    zc: Any
    zf: Any
    dz: float
    nz: int
    batch_shape: Tuple[int, ...]

    @property
    def dz_boundary(self) -> float:
        """Half-cell distance from the last center to the boundary face."""
        return self.dz / 2.0

    @property
    def shape(self) -> Tuple[int, ...]:
        """Shape of a center field on this grid."""
        return (self.nz, *self.batch_shape)


def make_function_space(
    domain, dtype: torch.dtype = torch.float64, device="cuda"
) -> ColumnGrid:
    """Build the (center, face) coordinate grid for a column, on ``device``
    (the card unless the caller asks for ``"cpu"``).

    The mesh arithmetic is done in float64 numpy and then cast, so float32
    grids still place centers at exact midpoints."""
    if not isinstance(domain, Column):
        raise NotImplementedError(
            f"{type(domain).__name__} is not ported yet (ROADMAP A13); "
            "only the uniform Column is"
        )
    np_dtype = _NP_DTYPES[dtype]
    zmin, zmax = float(domain.zlim[0]), float(domain.zlim[1])
    nz = int(domain.nelements)
    dz = (zmax - zmin) / nz
    zf = zmin + dz * np.arange(nz + 1, dtype=np.float64)
    zc = 0.5 * (zf[:-1] + zf[1:])
    ones = (1,) * len(domain.batch_shape)

    def conv(x):
        return torch.as_tensor(x.astype(np_dtype), device=device)

    return ColumnGrid(
        zc=conv(zc).reshape((nz, *ones)),
        zf=conv(zf).reshape((nz + 1, *ones)),
        dz=float(np_dtype(dz)),
        nz=nz,
        batch_shape=tuple(domain.batch_shape),
    )


def coordinates(grid: ColumnGrid):
    """Center z coordinates."""
    return grid.zc


def zero_field(grid: ColumnGrid, dtype=None):
    """A zero center field on the grid, including batch dims."""
    return torch.zeros(
        grid.shape,
        dtype=dtype if dtype is not None else grid.zc.dtype,
        device=grid.zc.device,
    )
