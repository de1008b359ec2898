"""Lagged coefficients on the stiff path leave the physical range at phase
8's step, in the JAX package as in the port.

``bench.py::build_stiff``'s sand infiltration (nz=64 x 8, water-only, a
Dirichlet top at 0.267 over 0.10-0.12) under ``TRBDF2Soil(iters=2)`` with
``coefficient_update="step"``: lagged K comes from the step's dry
start state while the Newton sweeps' Jacobian takes K at the wet iterate, so
at ``bench.py``'s 40 dt_exp (``chip_smoke.STIFF_FACTOR``) the update
overshoots and vartheta_l goes negative (-0.26 after two steps, -1.1 after
phase 8's eight), through the JAX package's ``Simulation`` (run without
jit: compiling its TR-BDF2 at nz=64 takes longer than stepping it) and
through the port's fused run's plain version alike.  At
``chip_smoke.STIFF_LAGGED_FACTOR`` dt_exp, over phase 18a's 8 steps, both
stay in range, agree at rtol 1e-12, and stay within bench.py's
max_dev_lagged bar (1e-2) of the stage-coefficient run (after two steps the
lagged run is 1.6e-2 away: the deviation peaks while the front is sharp).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs
from landhydrology_tpu import Simulation as JSimulation
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck

NZ, NCOL = 64, 8


@functools.lru_cache(maxsize=None)
def final_states(factor, lagged, steps):
    """``(JAX final vartheta_l, the port's)`` after ``steps`` steps of
    ``factor`` dt_exp."""
    jm, Y, Ya = bench.build_stiff(NZ, NCOL, jnp.float64)
    jm = dataclasses.replace(jm, coefficient_update="step" if lagged else "stage")
    model = model_from_reference(jm, device="cpu")
    Yt = state_from_numpy(Y, device="cpu")
    dt = factor * cs.stiff_dt_explicit(model, Yt)
    jst = JTRBDF2(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    with jax.disable_jit():
        sim = JSimulation(jm, jst, Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, steps * dt), saveat=steps * dt)
        sim.run()
    port = ck.fused_column_run_plain(model, cs.implicit("TRBDF2Soil", model, 2), dt, steps, Yt, 0.0)
    return np.asarray(sim.Y["soil"]["vartheta_l"]), port["soil"]["vartheta_l"].numpy()


def test_lagged_stiff_path_leaves_the_range_at_40_dt_exp_in_both():
    jax_v, port_v = final_states(cs.STIFF_FACTOR, True, 2)
    assert np.isfinite(jax_v).all() and np.isfinite(port_v).all()
    assert float(jax_v.min()) < -0.1 and float(port_v.min()) < -0.1


@pytest.mark.parametrize("lagged", [False, True], ids=["stage", "lagged"])
def test_stiff_path_at_phase_18a_step_matches_jax(lagged):
    jax_v, port_v = final_states(cs.STIFF_LAGGED_FACTOR, lagged, cs.STIFF_STEPS)
    np.testing.assert_allclose(port_v, jax_v, rtol=1e-12, atol=1e-16)
    assert 0.0999 < float(port_v.min()) and float(port_v.max()) < 0.287
    if lagged:
        stage, _ = final_states(cs.STIFF_LAGGED_FACTOR, False, cs.STIFF_STEPS)
        dev = float(np.max(np.abs(jax_v - stage)))
        assert 1e-4 < dev < 1e-2
