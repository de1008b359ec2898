"""Vertical finite-difference stencil operators, batched.

PyTorch port of ``landhydrology_tpu/ops/stencil.py``:

- interpolation: interior face value = arithmetic mean of adjacent centers;
- gradient: interior face gradient = (c[i] - c[i-1]) / dz;
- divergence: center value (F[i+1] - F[i]) / dz with the two boundary faces
  set to the BC flux values.

Flux is positive along +z.  The vertical axis is axis 0 of ``(nz, *batch)``
tensors.
"""

from __future__ import annotations

from typing import Any

import torch

Array = Any


def interp_c2f_interior(xc: Array) -> Array:
    """``(nz, *batch) -> (nz-1, *batch)``: face j gets ``(x[j-1] + x[j])/2``."""
    return 0.5 * (xc[:-1] + xc[1:])


def grad_c2f_interior(xc: Array, dz: Array) -> Array:
    """``(nz, *batch) -> (nz-1, *batch)``: face j gets ``(x[j] - x[j-1])/dz``."""
    return (xc[1:] - xc[:-1]) / dz


def _boundary_slab(value: Array, like_interior: Array) -> Array:
    """Broadcast a boundary flux value to one face-slab ``(1, *batch)``."""
    value = torch.as_tensor(
        value, dtype=like_interior.dtype, device=like_interior.device
    )
    return value.expand(like_interior.shape[1:])[None]


def div_f2c(flux_interior: Array, flux_bottom: Array, flux_top: Array, dz: Array) -> Array:
    """Face->center divergence with set boundary fluxes: ``flux_interior``
    ``(nz-1, *batch)`` holds faces 1..nz-1, ``flux_bottom``/``flux_top``
    (scalars or ``(*batch)``) faces 0 and nz; ``div[i] = (F[i+1] - F[i])/dz``."""
    fb = _boundary_slab(flux_bottom, flux_interior)
    ft = _boundary_slab(flux_top, flux_interior)
    flux = torch.cat([fb, flux_interior, ft], dim=0)  # (nz+1, *batch)
    return (flux[1:] - flux[:-1]) / dz


def diffusive_flux_faces(coeff_c: Array, field_c: Array, dz: Array) -> Array:
    """Interior-face diffusive flux ``-interp(K) * grad(u)``."""
    return -interp_c2f_interior(coeff_c) * grad_c2f_interior(field_c, dz)
