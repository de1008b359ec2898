"""The port's explicit steppers (``timestepping.py``) against the JAX
package's.

- ``stage_times`` of ForwardEuler ``(t,)``, SSPRK22 ``(t, t + dt)``, SSPRK33
  and SSPRK104 (ten times, ``dt/6`` accumulated) equal, bit for bit in f32
  and f64, the times the JAX package's ``step`` passes to the rhs; each of
  the port's steps passes its own ``stage_times`` (the kernel's BC and
  profile tables are built from them).
- The order test of ``tests/test_timestepping_order.py`` for the port's
  steppers (y' = y cos t, y(0) = 1: the observed order within 0.35 of 1,
  2, 3 and 4) and SSPRK104 against SSPRK33 at matched work.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import timestepping as jts
from landhydrology_tpu_torch import timestepping as pts

NAMES = ("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104")


def _jax_times(name, t, dt, dtype):
    seen = []

    def rhs(Y, Ya, tq):
        seen.append(np.asarray(tq))
        return {"m": {"y": Y["m"]["y"] * 0.0}}

    getattr(jts, name)().step(rhs, {"m": {"y": jnp.zeros((), dtype)}}, {}, jnp.asarray(t, dtype),
                              jnp.asarray(dt, dtype))
    return seen


def _port_times(name, t, dt, dtype):
    seen = []

    def rhs(Y, Ya, tq):
        seen.append(tq)
        return {"m": {"y": Y["m"]["y"] * 0.0}}

    getattr(pts, name)().step(rhs, {"m": {"y": torch.zeros((), dtype=dtype)}}, {}, torch.tensor(t, dtype=dtype),
                              torch.tensor(dt, dtype=dtype))
    return seen


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("t,dt", [(0.0, 1.0), (1234.5, 0.37), (86400.0 * 3, 7.1)])
def test_stage_times_match_jax_step(name, t, dt):
    for tdt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        st = getattr(pts, name)()
        times = st.stage_times(torch.tensor(t, dtype=tdt), torch.tensor(dt, dtype=tdt))
        assert len(times) == st.stages
        ref = _jax_times(name, t, dt, jdt)
        assert len(ref) == len(times)
        for a, b in zip(times, ref):
            assert a.dtype == tdt and a.item() == float(b), (name, [float(x) for x in times], ref)
        used = _port_times(name, t, dt, tdt)
        assert all(torch.equal(a, b) for a, b in zip(used, times))


def _rhs(Y, Ya, t):
    return {"m": {"y": Y["m"]["y"] * torch.cos(t)}}


def _solve(stepper, dt, tf=2.0):
    Y = {"m": {"y": torch.tensor(1.0, dtype=torch.float64)}}
    t = torch.tensor(0.0, dtype=torch.float64)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    for _ in range(int(round(tf / dt))):
        Y = stepper.step(_rhs, Y, {}, t, dt_t)
        t = t + dt_t
    return float(Y["m"]["y"])


@pytest.mark.parametrize(
    "stepper,expected_order",
    [(pts.ForwardEuler(), 1), (pts.SSPRK22(), 2), (pts.SSPRK33(), 3), (pts.SSPRK104(), 4)],
)
def test_observed_convergence_order(stepper, expected_order):
    exact = float(np.exp(np.sin(2.0)))
    dts = [0.2, 0.1, 0.05]
    errs = [abs(_solve(stepper, dt) - exact) for dt in dts]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)]
    assert orders[-1] > expected_order - 0.35, (errs, orders)
    assert errs[-1] < errs[0]


def test_ssprk104_accuracy_beats_ssprk33_per_work():
    exact = float(np.exp(np.sin(2.0)))
    err_104 = abs(_solve(pts.SSPRK104(), 0.2) - exact)
    err_33 = abs(_solve(pts.SSPRK33(), 0.06) - exact)
    assert err_104 < err_33


@pytest.mark.parametrize("name", NAMES)
def test_steps_match_jax_steps(name):
    """One step of each stepper on y' = y cos t equals the JAX package's to
    rtol 1e-15 (the two cos may differ in the last bit)."""
    def jrhs(Y, Ya, t):
        return {"m": {"y": Y["m"]["y"] * jnp.cos(t)}}

    ref = getattr(jts, name)().step(jrhs, {"m": {"y": jnp.asarray(1.3)}}, {}, jnp.asarray(0.4), jnp.asarray(0.25))
    got = _solve_one(getattr(pts, name)())
    np.testing.assert_allclose(got, float(ref["m"]["y"]), rtol=1e-15)


def _solve_one(stepper):
    Y = {"m": {"y": torch.tensor(1.3, dtype=torch.float64)}}
    out = stepper.step(_rhs, Y, {}, torch.tensor(0.4, dtype=torch.float64), torch.tensor(0.25, dtype=torch.float64))
    return float(out["m"]["y"])
