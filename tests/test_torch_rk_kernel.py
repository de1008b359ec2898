"""The in-kernel ForwardEuler, SSPRK22 and SSPRK104 (``csrc/rk_kernel.cu``)
in the plain-soil modes of the coupled column, through the kernel's plain
version on the CPU, against the JAX package.

- Golden #1's column (nz=24 x 8, 3 steps of dt=10 from t0 = 30 s: a
  callable Dirichlet top, free drainage, per-column soils) with stage
  coefficients, lagged coefficients, ``assume_no_ice`` and both; the freeze
  golden's column (nz=16 x 4, 4 steps of dt=5) with rate and equilibrium
  freeze-thaw, each alone and lagged: the port's ``make_fused_column_run``
  equals the JAX package's jitted XLA ``Simulation`` over the same steps at
  rtol 1e-12 (atol 1e-16), and is the mode's ``@<stepper>`` instance;
- one case per stepper against JAX's fused kernel in interpret mode (the
  Pallas body tracing the stepper), at the same bar.
- ``assume_no_ice`` on golden #1's column made icy (vartheta_l > nu -
  theta_i), where ``rhs.py`` caps theta_l at nu - theta_i (and the kernel
  instances with ``MODE_RHS_CAP``: every no-ice instance but the lagged
  ones, whose closures cap at nu as ``lagged.py``'s do): the plain version
  equals JAX under all four explicit steppers and the three implicit ones;
  the ``cuda``-marked tests hold the kernels to it there.

The branch modes are in ``test_torch_rk_branches.py``; the kernel itself is
held against this plain version on the card in ``chip_smoke.py`` phase 15a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JRate
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu.simulations import Simulation as JSimulation
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch import timestepping as pts
from tests.data import golden_config as gc

STEPPERS = ("ForwardEuler", "SSPRK22", "SSPRK104")
#: mode name, model options, column ("golden" or "freeze")
MODES = {
    "B1": ({}, "golden"),
    "B2": ({"coefficient_update": "step"}, "golden"),
    "B1-no-ice": ({"assume_no_ice": True}, "golden"),
    "B2-no-ice": ({"coefficient_update": "step", "assume_no_ice": True}, "golden"),
    "B3-rate": ({"freeze_thaw": JRate(tau=60.0)}, "freeze"),
    "B2+B3-rate": ({"coefficient_update": "step", "freeze_thaw": JRate(tau=60.0)}, "freeze"),
    "B3-eq": ({"freeze_thaw": JEq()}, "freeze"),
    "B2+B3-eq": ({"coefficient_update": "step", "freeze_thaw": JEq()}, "freeze"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def case(mode):
    """``(JAX model, JAX state, dt, steps, t0)`` of a mode's column."""
    options, column = MODES[mode]
    if column == "golden":
        model, Y, _, _ = gc.build_model_and_state(jnp.float64)
        dt, n, t0 = 10.0, 3, 30.0
    else:
        model, Y, _, _ = gc.build_freeze_model_and_state(jnp.float64)
        model = dataclasses.replace(model, freeze_thaw=None)
        dt, n, t0 = 5.0, 4, 0.0
    return dataclasses.replace(model, **options), Y, dt, n, t0


def jax_xla(jm, Y, stepper, dt, n, t0):
    """The JAX package's jitted XLA ``Simulation`` over ``n`` steps: its
    final state as numpy arrays."""
    sim = JSimulation(jm, getattr(jts, stepper)(), Y_init=Y, dt=dt, tspan=(t0, t0 + n * dt))
    sol = sim.run()
    return {k: np.asarray(v) for k, v in sol.state(-1)["soil"].items()}


def port_fused(jm, Y, stepper, dt, n, t0):
    """The port's fused run (its plain version on CPU tensors) from the
    JAX state: ``(run name, final state as numpy arrays)``."""
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, getattr(pts, stepper)(), dt=dt, steps_per_call=n)
    Yt = state_from_numpy(Y, device="cpu")
    run(Yt, t0)
    return run.name, {k: v.numpy() for k, v in Yt["soil"].items()}


def assert_same(got, ref, start):
    moved = False
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-12, atol=1e-16, err_msg=k)
        moved |= bool(np.any(r != np.asarray(start[k])))
    assert moved  # the steps changed the state


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_version_matches_jax_xla(mode, stepper):
    jm, Y, dt, n, t0 = case(mode)
    name, got = port_fused(jm, Y, stepper, dt, n, t0)
    assert name == f"{mode}@{stepper}"
    assert ck._entry(ck.make_fused_column_run(model_from_reference(jm, device="cpu"),
                                             getattr(pts, stepper)()).mode, torch.float64)[0] == "rk_kernel"
    assert_same(got, jax_xla(jm, Y, stepper, dt, n, t0), Y["soil"])


@pytest.mark.parametrize("stepper,mode", [("ForwardEuler", "B2-no-ice"), ("SSPRK22", "B3-eq"),
                                          ("SSPRK104", "B2+B3-rate")])
def test_plain_version_matches_jax_fused_kernel(stepper, mode):
    """One case per stepper against the JAX fused kernel in interpret mode."""
    jm, Y, dt, n, t0 = case(mode)
    ncol = jm.domain.batch_shape[0]
    ref = jax_fused(jm, getattr(jts, stepper)(), dt=dt, steps_per_call=n, tile_cols=ncol, interpret=True)(Y, t0)
    _, got = port_fused(jm, Y, stepper, dt, n, t0)
    assert_same(got, {k: np.asarray(v) for k, v in ref["soil"].items()}, Y["soil"])


def icy_case(mode):
    """``case(mode)`` with theta_i 0.05 and vartheta_l = nu - 0.02 in the
    lower half of the column: vartheta_l > nu - theta_i there."""
    jm, Y, dt, n, t0 = case(mode)
    soil = {k: np.array(v) for k, v in Y["soil"].items()}
    lower = slice(0, soil["vartheta_l"].shape[0] // 2)
    soil["theta_i"][lower] = 0.05
    soil["vartheta_l"][lower] = np.asarray(jm.soil_param_set.nu) - 0.02
    return jm, dict(Y, soil={k: jnp.asarray(v) for k, v in soil.items()}), dt, n, t0


@pytest.mark.parametrize("stepper", STEPPERS + ("SSPRK33",))
@pytest.mark.parametrize("mode", ["B1-no-ice", "B2-no-ice"])
def test_plain_version_matches_jax_on_an_icy_no_ice_state(mode, stepper):
    jm, Y, dt, n, t0 = icy_case(mode)
    soil = {k: np.asarray(v) for k, v in Y["soil"].items()}
    assert np.any(soil["vartheta_l"] > np.asarray(jm.soil_param_set.nu) - soil["theta_i"])
    name, got = port_fused(jm, Y, stepper, dt, n, t0)
    assert name.split("@")[0] == mode
    assert_same(got, jax_xla(jm, Y, stepper, dt, n, t0), Y["soil"])


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("mode", ["B1-no-ice", "B2-no-ice"])
def test_cuda_rk_no_ice_kernel_on_an_icy_state(cuda_device, mode, stepper):
    """The rk no-ice instances equal their plain version on the icy state
    at rtol 1e-12 (f64)."""
    jm, Y, dt, n, t0 = icy_case(mode)
    model = model_from_reference(jm, device=cuda_device)
    st = getattr(pts, stepper)()
    Yt = state_from_numpy(Y, device=cuda_device)
    plain = ck.fused_column_run_plain(model, st, dt, n, Yt, t0)
    ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)(Yt, t0)
    torch.cuda.synchronize()
    for k, v in plain["soil"].items():
        np.testing.assert_allclose(Yt["soil"][k].cpu().numpy(), v.cpu().numpy(), rtol=1e-12, atol=1e-16, err_msg=k)


#: the implicit steppers of the B4 no-ice instances, at dt = 60 s
IMPLICIT = ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards")


def implicit_icy(stepper, device):
    """``(JAX model, JAX stepper, port model, port stepper, state, dt, n,
    t0)``: golden #1's column with ``assume_no_ice`` on its icy state
    (``icy_case``), under an implicit stepper (iters=2) at dt = 60 s."""
    from landhydrology_tpu import imex as jimex
    from landhydrology_tpu.domains import make_function_space as jax_grid
    from landhydrology_tpu_torch.convert import stepper_from_reference

    jm, Y, _, _, t0 = icy_case("B1-no-ice")
    jst = getattr(jimex, stepper)(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    model = model_from_reference(jm, device=device)
    return jm, jst, model, stepper_from_reference(jst, model, device=device), Y, 60.0, 2, t0


@pytest.mark.parametrize("stepper", IMPLICIT)
def test_implicit_plain_version_matches_jax_on_an_icy_no_ice_state(stepper):
    """The B4 no-ice instances' plain version on the icy state against the
    JAX fused kernel in interpret mode (the implicit sweeps cap theta_l at nu
    - theta_i, as the rhs does), rtol 1e-12."""
    jm, jst, model, st, Y, dt, n, t0 = implicit_icy(stepper, "cpu")
    ncol = jm.domain.batch_shape[0]
    ref = jax_fused(jm, jst, dt=dt, steps_per_call=n, tile_cols=ncol, interpret=True)(Y, t0)
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)
    assert run.name == ck._STEPPER_NAMES[ck.kernel_mode(model, st) & ck.MODE_IMPLICIT] + "-no-ice"
    Yt = state_from_numpy(Y, device="cpu")
    run(Yt, t0)
    assert_same({k: v.numpy() for k, v in Yt["soil"].items()},
                {k: np.asarray(v) for k, v in ref["soil"].items()}, Y["soil"])


@pytest.mark.cuda
def test_cuda_ssprk33_no_ice_kernel_on_an_icy_state(cuda_device):
    """``column_kernel.cu``'s B1-no-ice (MODE_RHS_CAP) equals its plain
    version on the icy state at rtol 1e-12 (f64)."""
    jm, Y, dt, n, t0 = icy_case("B1-no-ice")
    model = model_from_reference(jm, device=cuda_device)
    Yt = state_from_numpy(Y, device=cuda_device)
    plain = ck.fused_column_run_plain(model, pts.SSPRK33(), dt, n, Yt, t0)
    run = ck.make_fused_column_run(model, pts.SSPRK33(), dt=dt, steps_per_call=n)
    assert ck._entry(run.mode, torch.float64)[0] == "column_kernel"
    run(Yt, t0)
    torch.cuda.synchronize()
    for k, v in plain["soil"].items():
        np.testing.assert_allclose(Yt["soil"][k].cpu().numpy(), v.cpu().numpy(), rtol=1e-12, atol=1e-16, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", IMPLICIT)
def test_cuda_implicit_no_ice_kernel_on_an_icy_state(cuda_device, stepper):
    """The B4 no-ice instances (MODE_RHS_CAP) equal their plain version on
    the icy state at rtol 1e-12 (f64)."""
    _, _, model, st, Y, dt, n, t0 = implicit_icy(stepper, cuda_device)
    Yt = state_from_numpy(Y, device=cuda_device)
    plain = ck.fused_column_run_plain(model, st, dt, n, Yt, t0)
    ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)(Yt, t0)
    torch.cuda.synchronize()
    for k, v in plain["soil"].items():
        np.testing.assert_allclose(Yt["soil"][k].cpu().numpy(), v.cpu().numpy(), rtol=1e-12, atol=1e-16, err_msg=k)


@pytest.mark.parametrize("stepper", STEPPERS + ("SSPRK33",))
def test_stage_table_and_rows(stepper):
    """The launch's stage table: one stage per row of the BC tables
    (``rows_per_step`` 1, 2, 3 and 10), stage coefficients from dt in the
    model dtype (SSPRK104's dt/6 and dt/10 as its step computes them), the
    last stage writing the state, and the scratch of the two stage states."""
    jm, _, _, _, _ = case("B1")
    model = model_from_reference(jm, device="cpu")
    st = getattr(pts, stepper)()
    dt = 0.7
    for dtype in (torch.float64, torch.float32):
        table = ck.stage_table(st, dt, dtype)
        assert len(table) == st.stages == len(st.stage_times(0.0, dt))
        assert table[-1][2] == 0 and table[0][1] == 0
        dt_t = torch.tensor(dt, dtype=dtype)
        hs = {float(dt_t)} if stepper != "SSPRK104" else {float(dt_t / 6.0), float(0.1 * dt_t)}
        assert {row[4][0] for row in table} == hs
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=2)
    fields = [torch.zeros(24, 8, dtype=torch.float64) for _ in range(3)]
    args, _ = run.launch_args(fields, None, 0.0, torch.device("cpu"))
    assert args.rows_per_step == args.n_stages == st.stages
    assert ck.scratch_fields(run.mode) == 6


def test_explicit_steppers_refused_where_no_kernel():
    """ForwardEuler, SSPRK22 and SSPRK104 with per-column BC kinds run on the
    plain soil in the column-tile kernel (``tile_columns_kernel.cu``,
    ``B1+kinds@<stepper>``); a MOST top runs in the land kernel
    (``B5@<stepper>``), with kinds in its ``MODE_COLUMNS`` instance
    (``B5+kinds@<stepper>``); TR-BDF2 under the MOST top with kinds runs in
    ``implicit_most_columns_kernel.cu`` (``B4-trbdf2+B5+kinds``), no longer
    refused (ROADMAP B1-batched)."""
    from landhydrology_tpu_torch import BatchedBC, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC

    jm, _, _, _, _ = case("B1")
    model = model_from_reference(jm, device="cpu")
    most = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2,
                                   q_atm=0.005),
        bottom=model.boundary_conditions.bottom))
    bcs = model.boundary_conditions
    kinds = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=bcs.top, bottom=SoilComponentBC(energy=bcs.bottom.energy,
                                            hydrology=BatchedBC(kind=torch.zeros(8, dtype=torch.int64)))))
    most_kinds = dataclasses.replace(most, boundary_conditions=SoilColumnBC(
        top=most.boundary_conditions.top, bottom=kinds.boundary_conditions.bottom))
    for stepper in STEPPERS:
        run = ck.make_fused_column_run(most, getattr(pts, stepper)())
        assert run.name == f"B5@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "land_rk_kernel"
        run = ck.make_fused_column_run(kinds, getattr(pts, stepper)())
        assert run.name == f"B1+kinds@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "tile_columns_kernel"
        run = ck.make_fused_column_run(most_kinds, getattr(pts, stepper)())
        assert run.name == f"B5+kinds@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "land_columns_kernel"
    from landhydrology_tpu_torch import TRBDF2Soil
    from landhydrology_tpu_torch.domains import make_function_space

    grid = make_function_space(most.domain, torch.float64, "cpu")
    run = ck.make_fused_column_run(most_kinds, TRBDF2Soil(model=most_kinds, grid=grid))
    assert run.name == "B4-trbdf2+B5+kinds"
    assert ck._entry(run.mode, torch.float64)[0] == "implicit_most_columns_kernel"
