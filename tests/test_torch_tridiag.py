"""The port's batched tridiagonal solvers (``ops/tridiag.py``) against the
JAX package's, on seeded strictly diagonally dominant systems, f64.

Thomas and PCR each match their JAX counterpart at rtol 1e-13 (the same
operations in the same order); PCR matches Thomas to the rounding of a
different elimination order, rtol 1e-12.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.ops.tridiag import pcr_solve as jax_pcr
from landhydrology_tpu.ops.tridiag import thomas_solve as jax_thomas
from landhydrology_tpu_torch.ops.tridiag import pcr_solve, thomas_solve


def _system(n, batch, seed):
    """``(dl, d, du, b)`` of shape ``(n, *batch)``, |d| > |dl| + |du|."""
    rng = np.random.default_rng(seed)
    shape = (n, *batch)
    dl = rng.uniform(-1.0, 1.0, shape)
    du = rng.uniform(-1.0, 1.0, shape)
    d = (np.abs(dl) + np.abs(du) + rng.uniform(0.5, 2.0, shape)) * rng.choice([-1.0, 1.0], shape)
    b = rng.uniform(-10.0, 10.0, shape)
    return dl, d, du, b


@pytest.mark.parametrize("n", [1, 2, 7, 64])
@pytest.mark.parametrize("solver", ["thomas", "pcr"])
def test_solver_matches_jax(n, solver):
    ours, ref = {"thomas": (thomas_solve, jax_thomas), "pcr": (pcr_solve, jax_pcr)}[solver]
    system = _system(n, (5, 3), seed=n)
    got = ours(*(torch.as_tensor(x) for x in system)).numpy()
    want = np.asarray(ref(*(jnp.asarray(x) for x in system)))
    assert got.shape == want.shape == (n, 5, 3)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_pcr_matches_thomas_and_solves_the_system(n):
    dl, d, du, b = _system(n, (17,), seed=100 + n)
    t = [torch.as_tensor(x) for x in (dl, d, du, b)]
    x_th = thomas_solve(*t).numpy()
    x_pcr = pcr_solve(*t).numpy()
    np.testing.assert_allclose(x_pcr, x_th, rtol=1e-12, atol=1e-14)
    # the corners dl[0], du[n-1] are ignored; the residual is rounding
    A_x = d * x_th
    A_x[1:] += dl[1:] * x_th[:-1]
    A_x[:-1] += du[:-1] * x_th[1:]
    np.testing.assert_allclose(A_x, b, rtol=1e-12, atol=1e-12)


def test_ignored_corners_are_never_read():
    dl, d, du, b = _system(6, (4,), seed=9)
    t = [torch.as_tensor(x) for x in (dl, d, du, b)]
    poisoned = [x.clone() for x in t]
    poisoned[0][0] = float("nan")
    poisoned[2][-1] = float("nan")
    for solve in (thomas_solve, pcr_solve):
        np.testing.assert_array_equal(solve(*poisoned).numpy(), solve(*t).numpy())
