"""Domains: the 1-D vertical soil column, batched.

PyTorch port of ``landhydrology_tpu/domains.py``.  Fields carry shape
``(nz, *batch_shape)``: the vertical axis leads and columns trail, so a
level of a column batch is contiguous in memory.  Coordinate tensors have
shape ``(nz, *[1]*len(batch_shape))`` so they broadcast against any batch;
a :class:`VariableDepthColumn` gives every column its own depth, and its
grid carries ``(nz, *batch)`` coordinates and a ``(*batch)`` spacing.
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


def _host_f64(x) -> np.ndarray:
    """A depth as a float64 numpy array on the host (a number, an array-like
    or a tensor on any device), never rounded to a model dtype."""
    if torch.is_tensor(x):
        x = x.detach().cpu().double().numpy()
    return np.array(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class VariableDepthColumn:
    """A batch of 1-D columns with per-column depths: each column keeps
    ``nelements`` cells, so fields stay dense ``(nz, *batch)`` tensors, and
    the spacing ``dz = (z_top - z_bottom) / nz`` varies per column.

    ``z_bottom`` / ``z_top`` are numbers or arrays broadcastable to
    ``batch_shape`` with ``z_bottom < z_top`` everywhere; they are kept as
    float64 host arrays, so a float32 grid rounds the float64 mesh once."""

    z_bottom: Any
    nelements: int
    batch_shape: Tuple[int, ...]
    z_top: Any = 0.0
    boundary_tags: Tuple[str, str] = ("bottom", "top")

    def __post_init__(self):
        object.__setattr__(self, "z_bottom", _host_f64(self.z_bottom))
        object.__setattr__(self, "z_top", _host_f64(self.z_top))
        zb = np.broadcast_to(self.z_bottom, self.batch_shape)
        zt = np.broadcast_to(self.z_top, self.batch_shape)
        if not np.all(zb < zt):
            raise ValueError(
                "VariableDepthColumn requires z_bottom < z_top for every column"
            )

    @property
    def ndims(self) -> int:
        return 1

    @property
    def height(self) -> np.ndarray:
        """Per-column physical height (float64, ``batch_shape``)."""
        return np.broadcast_to(self.z_top - self.z_bottom, self.batch_shape)

    def __repr__(self) -> str:
        h = self.height
        return (
            f"VariableDepthColumn(nz={self.nelements}, batch={self.batch_shape}, "
            f"depth [{h.min():0.2f}, {h.max():0.2f}])"
        )


@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """Discretized column: ``zc`` ``(nz, *ones)`` and ``zf`` ``(nz+1, *ones)``
    coordinate tensors, and the cell spacing ``dz`` as a Python float that is
    exactly representable in the grid's dtype; on a
    :class:`VariableDepthColumn`, ``(nz, *batch)`` / ``(nz+1, *batch)``
    coordinates and ``dz`` a ``(*batch)`` tensor.

    ``dz_boundary = dz/2`` is the half-cell center-to-face distance used in
    every Dirichlet-to-flux conversion."""

    zc: Any
    zf: Any
    dz: Any
    nz: int
    batch_shape: Tuple[int, ...]

    @property
    def dz_boundary(self) -> Any:
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
    np_dtype = _NP_DTYPES[dtype]

    def conv(x):
        return torch.as_tensor(x.astype(np_dtype), device=device)

    if isinstance(domain, VariableDepthColumn):
        nz = int(domain.nelements)
        batch = tuple(domain.batch_shape)
        zb = np.broadcast_to(domain.z_bottom, batch)
        dz = (np.broadcast_to(domain.z_top, batch) - zb) / nz  # (*batch)
        k = np.arange(nz + 1, dtype=np.float64).reshape((nz + 1,) + (1,) * len(batch))
        zf = zb[None] + k * dz[None]  # (nz+1, *batch)
        zc = 0.5 * (zf[:-1] + zf[1:])  # (nz, *batch)
        return ColumnGrid(zc=conv(zc), zf=conv(zf), dz=conv(dz), nz=nz, batch_shape=batch)
    if not isinstance(domain, Column):
        raise TypeError(f"expected a Column or a VariableDepthColumn; got {type(domain).__name__}")
    zmin, zmax = float(domain.zlim[0]), float(domain.zlim[1])
    nz = int(domain.nelements)
    dz = (zmax - zmin) / nz
    zf = zmin + dz * np.arange(nz + 1, dtype=np.float64)
    zc = 0.5 * (zf[:-1] + zf[1:])
    ones = (1,) * len(domain.batch_shape)
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
