"""The columns of ``experiments/soil/regional_grid.py``'s hour that leave
the physical range leave it in the JAX package too.

At dt=5 s a few columns pass their explicit stability limit during the
hour (a closed bottom that saturates, or a ponded top over a thin cell of
the variable-depth twin) and their SSPRK33 step blows up.  ``chip_smoke.py``
phase 12 holds the kernel and the plain version to blow up in the same
columns (``check_diverged``).  Here the same columns, cut out of
``chip_smoke.build_regional`` and out of the same draws built with the JAX
package, go through the JAX package's SSPRK33 step (XLA) and the port's
plain version on the CPU, one step at a time for the hour:

- the same columns leave the range (``chip_smoke._sound_columns``: a
  non-finite value, or vartheta_l outside [0, 1]) within the hour, each
  within ``STEP_SLACK`` steps of the other: once unstable, a column
  amplifies its rounding differences, so two correct implementations part
  some steps before the blow-up and reach it a few steps apart;
- the expected columns are among them: column 24619 of the grid, and the
  twin's columns listed in ``DIVERGING``;
- at every step at which JAX's state is finite, the port's step from JAX's
  state equals JAX's step (per column and field, the largest difference
  over the largest value: 1e-12 in f64, 1e-5 in f32), up to the last finite
  step.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu import (
    BatchedBC as JBatchedBC,
    BCKind as JBCKind,
    Column as JColumn,
    SoilColumnBC as JSoilColumnBC,
    SoilComponentBC as JSoilComponentBC,
    SoilEnergyModel as JSoilEnergyModel,
    SoilHydrologyModel as JSoilHydrologyModel,
    SoilModel as JSoilModel,
    SoilParams as JSoilParams,
    VariableDepthColumn as JVariableDepthColumn,
    VerticalFlux as JVerticalFlux,
    initialize_states as j_initialize_states,
)
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil import vanGenuchten as JvanGenuchten
from landhydrology_tpu.models.soil.heat import (
    k_solid as j_k_solid,
    ksat_frozen as j_ksat_frozen,
    ksat_unfrozen as j_ksat_unfrozen,
    volumetric_heat_capacity as j_vhc,
    volumetric_internal_energy as j_vie,
)
from landhydrology_tpu.models.soil.rhs import make_rhs as j_make_rhs
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch.convert import model_from_reference
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33

NZ, NCOL, DT, STEPS = cs.GRID_NZ, cs.GRID_NCOL, cs.GRID_DT, cs.GRID_STEPS
#: the columns each case runs: stable ones and those that blow up
COLUMNS = {False: [0, 64, 24619], True: [0, 534, 24619, 44556, 79949, 96642, 105411, 110682, 112326]}
#: the columns that leave the range within the hour, by (twin, dtype)
DIVERGING = {
    (False, torch.float64): {24619},
    (False, torch.float32): {24619},
    (True, torch.float64): {534, 24619, 44556, 79949, 96642, 105411, 112326},
    (True, torch.float32): {534, 24619, 44556, 79949, 96642, 105411, 110682, 112326},
}
STEP_SLACK = 8
ONE_STEP_BAR = {torch.float64: 1e-12, torch.float32: 1e-5}


def jax_regional(dtype, variable_depth, columns, ncol=NCOL):
    """``regional_grid.py``'s model and initial state built with the JAX
    package (its draws of ``ncol`` columns in its order from
    ``default_rng(7)``) in ``dtype``, on the twin's depths with
    ``variable_depth``, cut to ``columns``."""
    rng = np.random.default_rng(7)
    keep = np.asarray(columns)
    n = keep.size
    arr = lambda x: jnp.asarray(x[keep], dtype=dtype)  # noqa: E731
    nu = arr(rng.uniform(0.35, 0.52, ncol))
    hm = JvanGenuchten(
        n=arr(rng.uniform(1.4, 3.5, ncol)),
        alpha=arr(rng.uniform(1.5, 4.5, ncol)),
        Ksat=arr(10 ** rng.uniform(-7.0, -4.5, ncol)),
        theta_r=arr(rng.uniform(0.0, 0.08, ncol)),
    )
    ks = j_k_solid(0.0, 0.6, 7.7, 2.5, 0.25)
    msp = JSoilParams(nu=nu, S_s=1e-3, nu_ss_quartz=0.6, rho_c_ds=1.2e6, kappa_solid=ks,
                      kappa_sat_unfrozen=j_ksat_unfrozen(ks, 0.45, 0.57),
                      kappa_sat_frozen=j_ksat_frozen(ks, 0.45, 2.29))
    kinds_top = jnp.asarray(rng.integers(0, 2, ncol)[keep], dtype=jnp.int32)
    rain = arr(-10 ** rng.uniform(-8.0, -6.5, ncol))
    top_vals = jnp.where(kinds_top == JBCKind.DIRICHLET, 0.9 * nu, rain)
    kinds_bot = jnp.asarray(np.where(rng.random(ncol) < 0.5, JBCKind.FREE_DRAINAGE, JBCKind.FLUX)[keep],
                            dtype=jnp.int32)
    domain = JColumn(zlim=(-2.0, 0.0), nelements=NZ, batch_shape=(n,))
    if variable_depth:
        depths = np.random.default_rng(cs.GRID_DEPTH_SEED).uniform(0.8, 3.0, ncol)[keep]
        domain = JVariableDepthColumn(z_bottom=-depths, nelements=NZ, batch_shape=(n,))
    model = JSoilModel(
        domain=domain,
        energy_model=JSoilEnergyModel(),
        hydrology_model=JSoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=JSoilColumnBC(
            top=JSoilComponentBC(hydrology=JBatchedBC(kind=kinds_top, value=top_vals), energy=JVerticalFlux(0.0)),
            bottom=JSoilComponentBC(hydrology=JBatchedBC(kind=kinds_bot, value=jnp.zeros(n, dtype)),
                                    energy=JVerticalFlux(0.0)),
        ),
        soil_param_set=msp,
        dtype=dtype,
    )

    def ic(z, m):
        theta = jnp.broadcast_to((0.3 + 0.4 * arr(rng.random(ncol))) * nu, (NZ, n))
        ti = jnp.zeros((NZ, n), dtype)
        T = jnp.full((NZ, n), 288.0, dtype)
        return {"vartheta_l": theta, "theta_i": ti, "rho_e_int": j_vie(ti, j_vhc(theta, ti, 1.2e6, jps), T, jps)}

    return (model, *j_initialize_states(model, ic, 0.0))


def _leaves(obj, path=""):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}")
    elif not callable(obj) and not isinstance(obj, (str, torch.dtype)):
        yield path, obj


def _assert_same_model(model, jax_model, dtype):
    ref = model_from_reference(jax_model, device="cpu", dtype=dtype)
    got, want = dict(_leaves(model)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        else:
            assert got[k] == v, k


def test_jax_builder_is_the_script(monkeypatch):
    """``jax_regional`` at ncol=256 in float32 is ``regional_grid.py``'s
    model and initial state."""
    from tests.test_torch_chip_smoke import _regional_script_model

    script, script_Y = _regional_script_model(monkeypatch, 256)
    jm, jY, _ = jax_regional(jnp.float32, False, np.arange(256), ncol=256)
    _assert_same_model(model_from_reference(jm, device="cpu", dtype=torch.float32), script, torch.float32)
    for k in jY["soil"]:
        np.testing.assert_array_equal(np.asarray(jY["soil"][k]), np.asarray(script_Y["soil"][k]), err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("variable_depth", [False, True], ids=["grid", "twin"])
def test_regional_columns_blow_up_in_jax_too(variable_depth, dtype):
    jax_dtype = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    cols = np.asarray(COLUMNS[variable_depth])
    model, Y, _, _ = cs.build_regional(NZ, NCOL, dtype, "cpu", variable_depth, columns=cols)
    jm, jY, jYa = jax_regional(jax_dtype, variable_depth, cols)

    # the same model and start state on both sides
    _assert_same_model(model, jm, dtype)
    for k in Y["soil"]:
        np.testing.assert_array_equal(Y["soil"][k].numpy(), np.asarray(jY["soil"][k]), err_msg=k)

    rhs = j_make_rhs(jm)
    step = jax.jit(lambda Y, t: JSSPRK33().step(rhs, Y, jYa, t, jnp.asarray(DT, jax_dtype)))
    # one step of the fused run's plain version (fused_column_run_plain's step, built once)
    port_step, dt = ck.plain_step(model, SSPRK33(), torch.device("cpu")), torch.as_tensor(DT, dtype=dtype)
    t_jax, t_port = jnp.asarray(0.0, jax_dtype), torch.as_tensor(0.0, dtype=dtype)
    left = {"jax": np.full(cols.size, -1), "port": np.full(cols.size, -1)}
    worst = np.zeros(cols.size)
    for s in range(STEPS):
        start = {"soil": {k: torch.as_tensor(np.array(v)) for k, v in jY["soil"].items()}}
        one = port_step(start, t_port, dt)
        Y = port_step(Y, t_port, dt)
        jY = step(jY, t_jax)
        t_jax, t_port = t_jax + jnp.asarray(DT, jax_dtype), t_port + torch.as_tensor(DT, dtype=dtype)
        want = {k: np.asarray(v, dtype=np.float64) for k, v in jY["soil"].items()}
        for side, soil in (("jax", want), ("port", {k: v.double().numpy() for k, v in Y["soil"].items()})):
            left[side][~cs._sound_columns(soil) & (left[side] < 0)] = s
        # the port's step from JAX's state, on the columns JAX keeps finite
        finite = np.all([np.isfinite(v).all(0) for v in want.values()], axis=0)
        for k, v in one["soil"].items():
            with np.errstate(invalid="ignore"):
                diff = np.abs(v.double().numpy() - want[k]).max(0)
            scale = np.maximum(np.abs(want[k]).max(0), np.finfo(np.float64).tiny)
            worst[finite] = np.maximum(worst[finite], (diff / scale)[finite])

    assert np.all(worst <= ONE_STEP_BAR[dtype]), dict(zip(cols.tolist(), worst.tolist()))
    for side in ("jax", "port"):
        assert set(cols[left[side] >= 0].tolist()) == DIVERGING[(variable_depth, dtype)], (side, left[side])
    gone = left["jax"] >= 0
    assert np.all(np.abs(left["jax"][gone] - left["port"][gone]) <= STEP_SLACK), left
