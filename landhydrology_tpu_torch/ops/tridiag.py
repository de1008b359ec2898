"""Batched tridiagonal solves along the vertical axis.

PyTorch port of ``landhydrology_tpu/ops/tridiag.py``.  Columns are
independent, so each solve is a sweep over axis 0 of ``(n, *batch)``
tensors, vectorized over the batch.  Both solvers are Python loops over the
levels, as the JAX package unrolls them, and keep its order of operations:

- :func:`thomas_solve`: forward elimination in the reciprocal-multiply form
  (one reciprocal and two multiplies per row), then back substitution;
- :func:`pcr_solve`: parallel cyclic reduction, ``ceil(log2 n)`` levels of
  elementwise updates with shifted neighbours.

The CUDA kernel of the implicit steppers (``csrc/implicit_kernel.cu``)
runs the same two algorithms in each thread's own column.
"""

from __future__ import annotations

from typing import Any

import torch

Array = Any


def thomas_solve(dl: Array, d: Array, du: Array, b: Array) -> Array:
    """Solve ``A x = b`` for tridiagonal ``A`` batched over trailing dims.

    ``dl`` (sub-diagonal, entry i multiplies x[i-1]; dl[0] ignored), ``d``
    (diagonal), ``du`` (super-diagonal, entry i multiplies x[i+1]; du[n-1]
    ignored) and ``b`` all have shape ``(n, *batch)``.  No pivoting: the
    diffusion systems here are strictly diagonally dominant."""
    n = d.shape[0]
    if n == 1:
        return (b[0] / d[0])[None]

    inv = 1.0 / d[0]
    cp = [du[0] * inv]
    dp = [b[0] * inv]
    for i in range(1, n):
        inv = 1.0 / (d[i] - dl[i] * cp[i - 1])
        cp.append(du[i] * inv)
        dp.append((b[i] - dl[i] * dp[i - 1]) * inv)

    x = [dp[n - 1]]
    for i in range(n - 2, -1, -1):
        x.append(dp[i] - cp[i] * x[-1])
    x.reverse()
    return torch.stack(x, dim=0)


def _shift_down(x: Array, s: int, fill: float) -> Array:
    """``y[i] = x[i-s]``, with ``fill`` for i < s."""
    n = x.shape[0]
    pad = torch.full_like(x[0:1], fill)
    if s >= n:
        return pad.expand(x.shape)
    return torch.cat([pad.expand(x[0:s].shape), x[0 : n - s]], dim=0)


def _shift_up(x: Array, s: int, fill: float) -> Array:
    """``y[i] = x[i+s]``, with ``fill`` for i >= n-s."""
    n = x.shape[0]
    pad = torch.full_like(x[0:1], fill)
    if s >= n:
        return pad.expand(x.shape)
    return torch.cat([x[s:n], pad.expand(x[0:s].shape)], dim=0)


def pcr_solve(dl: Array, d: Array, du: Array, b: Array) -> Array:
    """Parallel cyclic reduction: the systems of :func:`thomas_solve`.  At
    each stride ``s`` every row eliminates its +-s neighbours,

        alpha_i = -a_i / d_{i-s},  gamma_i = -c_i / d_{i+s}
        a'_i = alpha_i a_{i-s},    c'_i = gamma_i c_{i+s}
        d'_i = d_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        b'_i = b_i + alpha_i b_{i-s} + gamma_i b_{i+s}

    with out-of-range neighbours the identity row (d = 1, a = c = b = 0);
    after the last level each equation is diagonal and x = b / d.  Rounding
    differs from Thomas's (another elimination order)."""
    n = d.shape[0]
    if n == 1:
        return (b[0] / d[0])[None]
    zero = torch.zeros_like(d[0:1])
    a = torch.cat([zero, dl[1:n]], dim=0)
    c = torch.cat([du[0 : n - 1], zero], dim=0)
    s = 1
    while s < n:
        inv_d = 1.0 / d
        alpha = -a * _shift_down(inv_d, s, 1.0)
        gamma = -c * _shift_up(inv_d, s, 1.0)
        d = d + alpha * _shift_down(c, s, 0.0) + gamma * _shift_up(a, s, 0.0)
        b = b + alpha * _shift_down(b, s, 0.0) + gamma * _shift_up(b, s, 0.0)
        a = alpha * _shift_down(a, s, 0.0)
        c = gamma * _shift_up(c, s, 0.0)
        s *= 2
    return b / d
