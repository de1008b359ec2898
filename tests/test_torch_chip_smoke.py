"""The pieces of ``chip_smoke.py`` that run without a GPU.

``build_bench_model`` rebuilds ``bench.py::build`` with the port's API; it
is held here against the JAX builder (state and rhs, rtol 1e-13 in
float64).  ``_check_increment`` is the check that lets the f32 main path
fail a kernel that changes the state too little; it is held here to accept
the plain version and to reject a kernel that does nothing, one that takes
a third of the steps and one that drops the water tendency, at the
benchmark's depth and a narrow width, in both dtypes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke as cs
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ, NCOL = 64, 32
MOVING = ("vartheta_l", "rho_e_int")


def test_bench_model_matches_jax_builder():
    jmodel, jY, jYa = bench.build(16, NCOL, jnp.float64)
    model, Y, Ya = cs.build_bench_model(16, NCOL, torch.float64, "cpu")
    ref_state = {k: np.asarray(v) for k, v in jY["soil"].items()}
    for k, v in cs._np(Y).items():
        np.testing.assert_allclose(v, ref_state[k], rtol=1e-13, atol=0, err_msg=k)
    ref = jax_make_rhs(jmodel)(jY, jYa, jnp.asarray(3.0, dtype=jnp.float64))
    got = make_rhs(model)(Y, Ya, torch.tensor(3.0, dtype=torch.float64))
    for k, v in cs._np(got).items():
        r = np.asarray(ref["soil"][k])
        scale = float(np.max(np.abs(r)))
        np.testing.assert_allclose(v, r, rtol=1e-13, atol=1e-13 * scale, err_msg=k)


@functools.lru_cache(maxsize=None)
def _runs(dtype):
    """(start, after 96 steps, after 32 steps) of the benchmark model."""
    model, Y0, _ = cs.build_bench_model(NZ, NCOL, dtype, "cpu")
    states, Y, t = [], Y0, torch.as_tensor(0.0, dtype=dtype)
    for _ in range(cs.N_STEPS // cs.SPC):
        Y = ck.fused_column_run_plain(model, SSPRK33(), cs.DT, cs.SPC, Y, t)
        t = t + cs.SPC * torch.as_tensor(cs.DT, dtype=dtype)
        states.append(cs._np(Y))
    return cs._np(Y0), states[-1], states[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_increment_check_accepts_the_plain_version(dtype):
    start, plain, _ = _runs(dtype)
    shares = cs._check_increment(plain, plain, start, dtype, "plain", MOVING)
    assert shares == {"vartheta_l": 0.0, "rho_e_int": 0.0}


@pytest.mark.parametrize("mutation", ["no_op", "third_of_the_steps", "no_water_tendency"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_increment_check_fails_kernels_that_change_too_little(dtype, mutation):
    start, plain, third = _runs(dtype)
    kern = {
        "no_op": start,
        "third_of_the_steps": third,
        "no_water_tendency": dict(plain, vartheta_l=start["vartheta_l"]),
    }[mutation]
    with pytest.raises(AssertionError, match="vartheta_l: change differs"):
        cs._check_increment(kern, plain, start, dtype, mutation, MOVING)
