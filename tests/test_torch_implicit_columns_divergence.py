"""The columns that the implicit steppers' checks with per-column kinds and
depths take out of the physical range leave it in the JAX package too.

``chip_smoke.py`` phase 20c steps its 1,000 cold columns under the implicit
steppers by 2 steps of 30 s, and a few of them (a Dirichlet face over a cold
column) leave ``chip_smoke._physical_columns``' range; phase 21c does the
same under the MOST top by 2 steps of 60 s.  The kernel and the plain
version are held to leave it in the same columns (``check_diverged``).
Here the variants come from ``chip_smoke``'s own functions on the CPU in f64
(20c's ``soil_columns_variant`` for implicit modes on the plain soil, 21c's
``most_columns_variant`` for one under the MOST top), and:

- the port's plain version finds the columns that leave the range, and the
  step at which each leaves it;
- those columns and a few sound ones, cut out by ``chip_smoke.column_slice``
  and carried over to the JAX package (``jax_model``: each dataclass by
  name, each tensor as an array, each callable BC value rebuilt on the same
  code with its closure's tensors as arrays, so both packages evaluate the
  same expression), go through JAX's fused kernel in interpret mode one step
  per launch (21c), or through the JAX package's implicit step with its
  step policies, eagerly (20c: its energy top's Dirichlet value is a
  per-column callable, which JAX's kernel refuses, "captures constants",
  while the port tabulates it per step and stage; and under ``jax.jit``
  the JAX package's check of energy ``BatchedBC`` kinds, ``boundary.py:388``,
  fails on a tracer in this JAX version, so not its ``Simulation`` either);
- the same columns leave the range at the same step in JAX, and after the
  first step the sound columns agree with the port at rtol 1e-12.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import landhydrology_tpu as jpkg
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import BackwardEulerSoil as JBES
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_regional_divergence import _assert_same_model

F64 = torch.float64
#: the sound columns each case also steps
SOUND = (0, 1, 999)
JAX_STEPPERS = {"BackwardEulerSoil": JBES, "TRBDF2Soil": JTRBDF2}


def _jax_classes():
    import landhydrology_tpu.constants as constants
    import landhydrology_tpu.models.soil as soil
    import landhydrology_tpu.models.soil.freeze_thaw as freeze_thaw

    out = {}
    for module in (jpkg, soil, freeze_thaw, constants):
        out.update({n: getattr(module, n) for n in dir(module) if isinstance(getattr(module, n), type)})
    return out


def jax_model(obj, cut=None, classes=None):
    """The JAX package's counterpart of a port model (or any part of one):
    its dataclasses by class name over the fields the JAX class has, tensors
    and host arrays as arrays, the dtype as JAX's; a user callable rebuilt on
    its own code with its closure's values carried over the same way (with
    ``cut``, ``(ncol, columns)``, a closure's ``(ncol,)`` tensor cut to the
    columns, which ``column_slice`` leaves as they are); the port's own
    default profiles left to the JAX class's defaults."""
    classes = _jax_classes() if classes is None else classes
    if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        return jnp.asarray(np.asarray(obj.cpu() if torch.is_tensor(obj) else obj))
    if isinstance(obj, torch.dtype):
        return {torch.float64: jnp.float64, torch.float32: jnp.float32}[obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = classes[type(obj).__name__]
        names = {f.name for f in dataclasses.fields(cls) if f.init}
        kwargs = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if f.init and f.name in names and not (callable(value) and not dataclasses.is_dataclass(value)
                                                    and value.__module__.startswith("landhydrology_tpu_torch")):
                kwargs[f.name] = jax_model(value, cut, classes)
        return cls(**kwargs)
    if isinstance(obj, types.FunctionType):
        def carried(v):
            if cut is not None and torch.is_tensor(v) and tuple(v.shape) == (cut[0],):
                v = v[torch.as_tensor(cut[1])]
            return jax_model(v, cut, classes)

        cells = tuple(types.CellType(carried(c.cell_contents)) for c in obj.__closure__ or ())
        return types.FunctionType(obj.__code__, obj.__globals__, obj.__name__, obj.__defaults__, cells or None)
    return obj


def steps_out(states):
    """Per column, the first step (1-based) at which it is out of the range,
    0 where it never is."""
    out = np.zeros(next(iter(states[0].values())).shape[1], dtype=int)
    for s, state in enumerate(states, 1):
        out[(out == 0) & ~cs._physical_columns(state)] = s
    return out


def _np(Y):
    return {k: np.asarray(v, dtype=np.float64) for k, v in Y["soil"].items()}


#: the implicit modes of each check and its t0: 20c's two whose steps take the most columns out of the range (1 and
#: 5 of 1,000), and 21c's BackwardEulerSoil twin of the first
CASES = {
    "20c": ("B4-be-soil-no-ice+B2", 2.0),
    "20c-eq": ("B4-trbdf2+B2+B3-eq", 2.0),
    "21c": ("B4-be-soil-no-ice+B2+B5", 5.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_diverging_columns_leave_the_range_in_jax_too(case):
    mode, t0 = CASES[case]
    if case.startswith("20c"):
        model, Y, st, dt, _ = cs.soil_columns_variant(cs.SOIL_COLUMNS_NCOL, F64, "cpu", 7, mode, None, "thomas")
        steps = cs.SOIL_IMPLICIT_STEPS
    else:
        model, Y, st, dt, steps = cs.most_columns_variant(cs.COLD_NCOL, F64, "cpu", mode)
    # the port's plain version over the 1,000 columns, one step at a time
    port, state, t = [], Y, t0
    for _ in range(steps):
        state = ck.fused_column_run_plain(model, st, dt, 1, state, t)
        port.append(cs._np(state))
        t += dt
    port_out = steps_out(port)
    diverging = np.flatnonzero(port_out)
    assert diverging.size <= max(2, cs.COLD_NCOL // 100)
    if case.startswith("20c"):
        assert diverging.size > 0  # the columns 20c holds equal in the kernel and the plain version

    cols = np.unique(np.concatenate([diverging, SOUND]))
    sub, Ys = cs.column_slice(model, Y, torch.as_tensor(cols))
    jm = jax_model(sub, cut=(Y["soil"]["vartheta_l"].shape[1], cols))

    _assert_same_model(sub, jm, F64)
    jst = JAX_STEPPERS[type(st).__name__](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    jY = {"soil": {k: jnp.asarray(v.numpy()) for k, v in Ys["soil"].items()}}
    if case.startswith("20c"):  # a per-column callable BC value: the steps the kernel traces, eagerly
        from landhydrology_tpu.models.soil.initial_conditions import initialize_auxiliary
        from landhydrology_tpu.models.soil.lagged import wrap_stepper_for_soil
        from landhydrology_tpu.models.soil.rhs import make_rhs

        from landhydrology_tpu.models.soil.freeze_thaw import wrap_stepper_with_projection

        # the policies as the JAX package's Simulation wraps them: the projection inside, lagged outside
        projected = jst if jm.freeze_thaw is None else wrap_stepper_with_projection(jst, jm)
        step, rhs = wrap_stepper_for_soil(projected, jm).step, make_rhs(jm)
        jYa = initialize_auxiliary(jm, jnp.asarray(t0, jnp.float64), jax_grid(jm.domain, jnp.float64).zc)
        jax_states, t = [], t0
        for _ in range(steps):
            jY = step(rhs, jY, jYa, jnp.asarray(t, jnp.float64), jnp.asarray(dt, jnp.float64))
            jax_states.append(_np(jY))
            t += dt
    else:
        kernel = jax.jit(jax_fused(jm, jst, dt=dt, steps_per_call=1, tile_cols=cols.size, interpret=True))
        jax_states, t = [], t0
        for _ in range(steps):
            jY = kernel(jY, t)
            jax_states.append(_np(jY))
            t += dt
    np.testing.assert_array_equal(steps_out(jax_states), port_out[cols], err_msg=f"columns {cols.tolist()}")
    for k, v in jax_states[0].items():
        np.testing.assert_allclose(port[0][k][:, cols], v, rtol=1e-12, atol=1e-16, err_msg=k)
