"""The port's forced runs (``landhydrology_tpu_torch/runtime/forcing_driver.py``
and kernel mode B7 of ``ops/cuda/column_kernel.py``) against the JAX
package's ``runtime/forcing_driver.py``.

- ``golden_forced_f64.npz`` through the eager engine ``"torch"`` and the
  fused engine on the CPU (the kernel's plain version), rtol 1e-13, and
  ``golden_config_torch`` rebuilds the golden's model, state and rows;
- ``make_forced_segment_run`` of both engines against JAX's XLA engine on
  the configurations of ``tests/test_forcing_driver.py`` (the diurnal MOST
  column, a scalar row with a remainder launch, the land rain pulse), and
  the eager TR-BDF2;
- ``run_forced`` over file windows equals one in-memory segment, with the
  prefetch serving reads;
- ``TimeForcedStepper`` and the time-indexed fused run against JAX's
  stepper: clamping at both table ends, a step on a row boundary;
- the routing and validation errors, and the unported combinations, which
  raise naming their ROADMAP item;
- on the card (``cuda``-marked, skipped without a GPU): the kernel against
  its plain version and the golden.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu.models import land as jland
from landhydrology_tpu.runtime import forcing_driver as jfd
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch.convert import (
    forcing_from_numpy,
    model_from_reference,
    state_from_numpy,
    state_to_numpy,
)
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import TRBDF2Soil
from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.runtime import (
    ForcingReader,
    make_forced_segment_run,
    run_forced,
    write_forcing,
)
from landhydrology_tpu_torch.runtime import forcing_driver as fd
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests import test_forcing_driver as jt
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct

GOLDEN = "tests/data/golden_forced_f64.npz"
F64 = torch.float64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _close(got, ref, rtol, atol=1e-18):
    for group, fields in ref.items():
        for k, v in fields.items():
            np.testing.assert_allclose(np.asarray(got[group][k]), np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{group}/{k}")


def _np_state(Y):
    """A nested dict of JAX arrays as numpy arrays."""
    return {k: _np_state(v) for k, v in Y.items()} if isinstance(Y, dict) else np.asarray(Y)


def _soil_case():
    jm = jt._atmos_soil()
    Y, Ya = jt.initialize_states(jm, jt._ic, 0.0)
    return jm, Y, Ya


def _land_case(n_steps=30, seed=1):
    """The land rain pulse of ``test_forcing_driver.py:124``: per-column
    rain above the tight soil's capacity for steps 5-14, a diurnal
    atmosphere, tau_pond 240 s."""
    soil = dataclasses.replace(jt._atmos_soil(), hydrology_model=jt.SoilHydrologyModel(
        hydraulic_model=jt.vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7, theta_r=0.05)))
    jm = jland.LandModel(soil=soil, surface=jland.SurfaceWaterModel(tau_pond=240.0))
    Y, Ya = jland.initialize_states(jm, jt._ic, 0.0, h_s0=0.0)
    rain = np.zeros((n_steps, jt.NCOL))
    rain[5:15] = 8e-6
    rows = {"precipitation": rain, **jt._diurnal_forcing(n_steps, np.random.default_rng(seed))}
    return jm, Y, Ya, rows


def _port(jm, Y, Ya):
    return model_from_reference(jm, device="cpu"), state_from_numpy(_np_state(Y), device="cpu"), \
        state_from_numpy(_np_state(Ya), device="cpu")


# ---- the golden ----


def test_golden_config_torch_builds_the_forced_golden():
    jm, jY, _, jrows, jdt = gc.build_forced_model_state_and_rows(jnp.float64)
    model, Y, _, rows, dt = gct.build_forced_model_state_and_rows(F64, "cpu")
    assert dt == jdt and model == model_from_reference(jm, device="cpu")
    _close(state_to_numpy(Y), _np_state(jY), rtol=0, atol=0)
    for k, v in jrows.items():
        np.testing.assert_array_equal(rows[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_forced_golden_both_engines(engine):
    golden = np.load(GOLDEN)
    model, Y, Ya, rows, dt = gct.build_forced_model_state_and_rows(F64, "cpu")
    seg = make_forced_segment_run(model, SSPRK33(), dt=dt, field_names=sorted(rows), engine=engine,
                                  steps_per_call=8)
    Yf, tf = seg(Y, Ya, 0.0, rows)
    assert float(tf) == gct.FORCED_STEPS * dt
    for k in ("vartheta_l", "theta_i", "rho_e_int"):
        np.testing.assert_allclose(Yf["soil"][k].numpy(), golden[k], rtol=1e-13, atol=1e-18, err_msg=k)
    # the rows mattered: the same run under the first row throughout ends elsewhere
    flat = {k: v[:1].expand(v.shape) for k, v in rows.items()}
    Yc, _ = seg(Y, Ya, 0.0, flat)
    assert float(torch.max(torch.abs(Yc["soil"]["rho_e_int"] - Yf["soil"]["rho_e_int"]))) > 1.0


# ---- the segment run against JAX's XLA engine ----


def _soil_rows(case):
    if case == "diurnal":
        return 40, jt._diurnal_forcing(40, np.random.default_rng(0))
    rows = jt._diurnal_forcing(29, np.random.default_rng(7))  # test_forcing_driver.py:191
    rows["theta_atm"] = rows["theta_atm"][:, 0].copy()  # one scalar row
    return 29, rows


@pytest.mark.parametrize("case", ["diurnal", "scalar_row_and_remainder", "land_rain_pulse"])
def test_segment_matches_jax_xla(case):
    if case == "land_rain_pulse":
        jm, jY, jYa, rows = _land_case()
    else:
        jm, jY, jYa = _soil_case()
        _, rows = _soil_rows(case)
    seg_x = jfd.make_forced_segment_run(jm, JSSPRK33(), dt=jt.DT, field_names=sorted(rows))
    Yx, tx = seg_x(jY, jYa, 0.0, {k: jnp.asarray(v) for k, v in rows.items()})
    ref = _np_state(Yx)
    if case == "land_rain_pulse":
        assert float(np.max(ref["surface"]["h_s"])) > 1e-5  # the pulse ponded
    model, Y, Ya = _port(jm, jY, jYa)
    for engine, rtol in (("torch", 1e-13), ("fused", 1e-12)):
        seg = make_forced_segment_run(model, SSPRK33(), dt=jt.DT, field_names=sorted(rows), engine=engine,
                                      steps_per_call=8)
        Yp, tp = seg(Y, Ya, 0.0, forcing_from_numpy(rows, device="cpu"))
        assert float(tp) == float(tx)
        _close(state_to_numpy(Yp), ref, rtol=rtol)
    # the fused run leaves its input state as it was
    _close(state_to_numpy(Y), _np_state(jY), rtol=0, atol=0)


def test_eager_forced_trbdf2_matches_jax():
    """``test_forcing_driver.py:514``'s forced TR-BDF2 (12 steps of dt=300)
    through the eager engine against JAX's XLA engine, and through the fused
    engine (kernel mode B4-trbdf2+B5+B7, on the CPU its plain version; 3
    launches of 4 steps) at JAX's own bar between its engines (rtol
    1e-11)."""
    jm, jY, jYa = _soil_case()
    rows = jt._diurnal_forcing(12, np.random.default_rng(17))
    jst = JTRBDF2(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    Yx, _ = jfd.make_forced_segment_run(jm, jst, dt=300.0, field_names=sorted(rows))(
        jY, jYa, 0.0, {k: jnp.asarray(v) for k, v in rows.items()})
    model, Y, Ya = _port(jm, jY, jYa)
    st = TRBDF2Soil(model=model, grid=make_function_space(model.domain, F64, "cpu"), iters=2)
    Yp, _ = make_forced_segment_run(model, st, dt=300.0, field_names=sorted(rows))(Y, Ya, 0.0, rows)
    _close(state_to_numpy(Yp), _np_state(Yx), rtol=1e-12)
    assert ck.make_fused_column_run(model, st, forcing_fields=sorted(rows)).name == "B4-trbdf2+B5+B7"
    seg = make_forced_segment_run(model, st, dt=300.0, field_names=sorted(rows), engine="fused", steps_per_call=4)
    Yf, _ = seg(Y, Ya, 0.0, rows)
    _close(state_to_numpy(Yf), _np_state(Yx), rtol=1e-11, atol=1e-15)


# ---- run_forced over file windows ----


@pytest.mark.parametrize("engine", ["torch", "fused"])
@pytest.mark.parametrize("case", ["soil", "land"])
def test_run_forced_windows_equal_one_segment(tmp_path, case, engine):
    if case == "land":
        jm, jY, jYa, rows = _land_case(n_steps=20, seed=4)
        window = 8
    else:
        jm, jY, jYa = _soil_case()
        rows = jt._diurnal_forcing(24, np.random.default_rng(5))
        window = 10
    n_steps = next(iter(rows.values())).shape[0]
    path = str(tmp_path / "forcing.bin")
    write_forcing(path, np.arange(n_steps) * jt.DT, rows)
    model, Y, Ya = _port(jm, jY, jYa)
    seg = make_forced_segment_run(model, SSPRK33(), dt=jt.DT, field_names=sorted(rows), engine=engine,
                                  steps_per_call=4)
    Yref, tref = seg(Y, Ya, 0.0, rows)
    for overlap in (True, False):
        seen = []
        with ForcingReader(path) as reader:
            Yf, tf = run_forced(model, Y, Ya, reader, SSPRK33(), dt=jt.DT, window=window, engine=engine,
                                steps_per_call=4, overlap=overlap,
                                on_window=lambda i0, Yw, tw: seen.append((i0, float(tw))))
            assert reader.is_native and reader.prefetch_hits > 0
        ends = list(range(window, n_steps, window)) + [n_steps]
        assert seen == [(i0, e * jt.DT) for i0, e in zip(range(0, n_steps, window), ends)]
        assert float(tf) == float(tref)
        _close(state_to_numpy(Yf), state_to_numpy(Yref), rtol=1e-13)


def test_run_forced_routes_a_subset_and_scalar_rows(tmp_path):
    """``fields`` picks the routed fields; a file of width 1 gives scalar
    rows; a width other than 1 or ncol raises."""
    jm, jY, jYa = _soil_case()
    model, Y, Ya = _port(jm, jY, jYa)
    rows = jt._diurnal_forcing(12, np.random.default_rng(6))
    path = str(tmp_path / "scalar.bin")
    write_forcing(path, np.arange(12) * jt.DT, {k: v[:, :1] for k, v in rows.items()})
    seg = make_forced_segment_run(model, SSPRK33(), dt=jt.DT, field_names=("u_atm",))
    Yref, _ = seg(Y, Ya, 0.0, {"u_atm": rows["u_atm"][:, 0]})
    with ForcingReader(path) as reader:
        Yf, _ = run_forced(model, Y, Ya, reader, SSPRK33(), dt=jt.DT, window=5, fields=["u_atm"])
    _close(state_to_numpy(Yf), state_to_numpy(Yref), rtol=0, atol=0)
    wide = str(tmp_path / "wide.bin")
    write_forcing(wide, np.arange(12.0), {"u_atm": np.ones((12, 3))})
    with ForcingReader(wide) as reader, pytest.raises(ValueError, match="columns"):
        run_forced(model, Y, Ya, reader, dt=jt.DT)
    with ForcingReader(path) as reader, pytest.raises(KeyError, match="not in the file"):
        run_forced(model, Y, Ya, reader, dt=jt.DT, fields=["rho_a_sfc"])


# ---- time-indexed rows ----


def _clamp_tables():
    """``test_forcing_driver.py:556``: a 4-row table from t = 200 with rows
    100 s apart; 9 steps of dt = 100 from t = 0 read rows 0, 0, 0, 1, 2, 3,
    3, 3, 3, the fourth step landing exactly on a row boundary."""
    return {
        "u_atm": np.asarray([1.0, 2.0, 3.0, 4.0]),
        "q_atm": 0.003 + 0.001 * np.arange(4)[:, None] + np.zeros((4, jt.NCOL)),
    }


def test_time_forced_stepper_matches_jax_and_the_fused_run():
    tables = _clamp_tables()
    jm, jY, jYa = _soil_case()
    jst = jfd.TimeForcedStepper(inner=JSSPRK33(), model=jm, grid=jax_grid(jm.domain, jnp.float64),
                                tables={k: jnp.asarray(v) for k, v in tables.items()}, t_start=200.0,
                                dt_forcing=100.0)
    model, Y, Ya = _port(jm, jY, jYa)
    st = fd.TimeForcedStepper(inner=SSPRK33(), model=model, grid=make_function_space(model.domain, F64, "cpu"),
                              tables=forcing_from_numpy(tables, device="cpu"), t_start=200.0, dt_forcing=100.0)
    assert (st.order, st.stages) == (3, 3)
    jstep = jax.jit(lambda Y_, t_: jst.step(None, Y_, jYa, t_, jnp.asarray(100.0)))
    Yx, Yp, t = jY, Y, 0.0
    for _ in range(9):
        Yx = jstep(Yx, jnp.asarray(t))
        Yp = st.step(None, Yp, Ya, torch.tensor(t, dtype=F64), torch.tensor(100.0, dtype=F64))
        t += 100.0
    _close(state_to_numpy(Yp), _np_state(Yx), rtol=1e-13)
    # the fused run's time-indexed rows (the plain version on the CPU) read the same rows
    run = ck.make_fused_column_run(model, SSPRK33(), dt=100.0, steps_per_call=9,
                                   forcing_fields=("q_atm", "u_atm"), forcing_time_grid=(200.0, 100.0, 4))
    assert run.name == "B5+B7-time"
    Yk = run(state_from_numpy(_np_state(jY), device="cpu"), 0.0, forcing=tables)
    _close(state_to_numpy(Yk), state_to_numpy(Yp), rtol=1e-13)
    seq = [0, 0, 0, 1, 2, 3, 3, 3, 3]
    Ys = ck.fused_column_run_plain(model, SSPRK33(), 100.0, 9, Y, 0.0,
                                   forcing={k: v[seq] for k, v in tables.items()})
    _close(state_to_numpy(Ys), state_to_numpy(Yk), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_time_row_is_the_reciprocal_product(dtype):
    """``time_row`` is JAX's ``clip(int32((t - t0) * (1 / dtF)), 0, n - 1)``
    with the reciprocal rounded to the dtype: over steps of dt = 0.1 on a
    grid of dtF = 0.1 (every step on a row boundary in exact arithmetic),
    from before the table's start to past its end."""
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    n_rows, t_start, dtF = 25, 0.3, 0.1
    for i in range(40):
        t = torch.tensor(i, dtype=dtype) * torch.tensor(0.1, dtype=dtype)
        jt_ = jnp.asarray(i, dtype=jdt) * jnp.asarray(0.1, dtype=jdt)
        want = int(jnp.clip(((jt_ - jnp.asarray(t_start, jdt)) * jnp.asarray(1.0 / dtF, jdt)).astype(jnp.int32),
                            0, n_rows - 1))
        assert fd.time_row(t, t_start, dtF, n_rows) == want, i
    assert fd.time_row(torch.tensor(1e30, dtype=dtype), 0.0, 1.0, 7) == 6
    assert fd.time_row(torch.tensor(-1e30, dtype=dtype), 0.0, 1.0, 7) == 0


# ---- validation, routing and what is not ported ----


def test_routing_errors():
    jm, jY, jYa = _soil_case()
    model = model_from_reference(jm, device="cpu")
    with pytest.raises(KeyError, match="route nowhere"):
        make_forced_segment_run(model, field_names=("u_atm", "banana"))
    with pytest.raises(TypeError, match="LandModel"):
        make_forced_segment_run(model, field_names=("precipitation",))
    no_atmos = dataclasses.replace(model, boundary_conditions=model_from_reference(
        gc.build_model_and_state(jnp.float64)[0], device="cpu").boundary_conditions)
    with pytest.raises(TypeError, match="PrescribedAtmosForcing"):
        make_forced_segment_run(no_atmos, field_names=("u_atm",))
    with pytest.raises(TypeError, match="PrescribedAtmosForcing"):
        ck.make_fused_column_run(no_atmos, forcing_fields=("u_atm",))
    with pytest.raises(ValueError, match="unknown engine"):
        make_forced_segment_run(model, field_names=("u_atm",), engine="xla")


def test_fused_forcing_validation():
    jm, jY, jYa = _soil_case()
    model, Y, _ = _port(jm, jY, jYa)
    with pytest.raises(ValueError, match="forcing_time_grid requires"):
        ck.make_fused_column_run(model, forcing_time_grid=(0.0, 1.0, 4))
    for grid in ((0.0, 1.0, 0), (0.0, 0.0, 4), (0.0, -1.0, 4)):
        with pytest.raises(ValueError, match="n_rows >= 1 and dt_forcing > 0"):
            ck.make_fused_column_run(model, forcing_fields=("u_atm",), forcing_time_grid=grid)
    run = ck.make_fused_column_run(model, steps_per_call=3, forcing_fields=("u_atm", "q_atm"))
    assert run.name == "B5+B7" and run.n_frows == 3
    rows = {"u_atm": np.full(3, 2.0), "q_atm": np.full((3, jt.NCOL), 0.005)}
    with pytest.raises(ValueError, match="streams forcing fields"):
        run(Y, 0.0)
    with pytest.raises(KeyError, match="declared forcing_fields"):
        run(Y, 0.0, forcing={"u_atm": rows["u_atm"]})
    with pytest.raises(ValueError, match=r"expected \(3,\) or \(3, 16\)"):
        run(Y, 0.0, forcing=dict(rows, u_atm=np.full(4, 2.0)))
    with pytest.raises(ValueError, match="without forcing_fields"):
        ck.make_fused_column_run(model, steps_per_call=3)(Y, 0.0, forcing=rows)
    # a run-time step size (kernel mode B1-dt) is a run built with that dt, bit for bit
    at_dt_run = run({g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}, 0.0, forcing=rows, dt_run=0.5)
    built = ck.make_fused_column_run(model, dt=0.5, steps_per_call=3, forcing_fields=("u_atm", "q_atm"))(
        {g: {k: v.clone() for k, v in f.items()} for g, f in Y.items()}, 0.0, forcing=rows)
    _close(state_to_numpy(at_dt_run), state_to_numpy(built), rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"expects \(5,\) or \(5, 16\)"):
        make_forced_segment_run(model, field_names=("u_atm",), engine="fused")(
            Y, None, 0.0, {"u_atm": np.ones((5, 3))})


def test_per_column_rain_streams_as_rows_but_not_as_a_callable():
    jm, jY, jYa, rows = _land_case(n_steps=4)
    model = model_from_reference(jm, device="cpu")
    per_column = dataclasses.replace(model, surface=dataclasses.replace(
        model.surface, precipitation=lambda t: torch.full((jt.NCOL,), 1e-6, dtype=F64)))
    with pytest.raises(ValueError, match="per-column precipitation"):
        ck.make_fused_column_run(per_column)
    run = ck.make_fused_column_run(per_column, steps_per_call=4, forcing_fields=("precipitation",))
    assert run.name == "B6+B7"


def test_unported_forced_combinations_raise_naming_their_item():
    """Freeze-thaw and no ice take forcing rows under MOST and a LandModel,
    under the other explicit steppers too, and so does per-column geometry;
    per-column geometry with rows under the implicit steppers (B8) runs in
    ``implicit_most_columns_kernel.cu``, no longer refused."""
    from landhydrology_tpu_torch.timestepping import SSPRK104

    jm, jY, jYa = _soil_case()
    model = model_from_reference(jm, device="cpu")
    frozen = dataclasses.replace(model, freeze_thaw=FreezeThaw(tau=60.0))
    assert ck.make_fused_column_run(frozen, forcing_fields=("u_atm",)).name == "B5+B3-rate+B7"
    jland_m, _, _, _ = _land_case(n_steps=2)
    land = model_from_reference(jland_m, device="cpu")
    no_ice = dataclasses.replace(land, soil=dataclasses.replace(land.soil, assume_no_ice=True))
    make_forced_segment_run(no_ice, field_names=("precipitation",), engine="fused")
    make_forced_segment_run(no_ice, SSPRK104(), field_names=("precipitation",), engine="fused")
    run = ck.make_fused_column_run(no_ice, SSPRK104(), forcing_fields=("precipitation",))
    assert run.name == "B6-no-ice+B7@SSPRK104"
    grid = make_function_space(model.domain, F64, "cpu")
    ncol = model.domain.batch_shape[0]
    geometry = (torch.full((ncol,), 0.1, dtype=F64), grid.zc.expand(-1, ncol).contiguous())
    run = ck.make_fused_column_run(frozen, SSPRK104(), forcing_fields=("u_atm",), streamed_geometry=geometry)
    assert run.name == "B5+B3-rate+B8+B7@SSPRK104"
    run = ck.make_fused_column_run(model, TRBDF2Soil(model=model, grid=grid), forcing_fields=("u_atm",),
                                   streamed_geometry=geometry)
    assert run.name == "B4-trbdf2+B5+B8+B7"
    assert ck._entry(run.mode, F64)[0] == "implicit_most_columns_kernel"


def test_kernel_args_carry_the_rows():
    """The argument struct points each forced input at its rows with their
    strides (the chunk's offset in the pointer), flags it, and holds the
    time grid in the model dtype; the rest keep their tables."""
    jm, jY, jYa, rows = _land_case(n_steps=6)
    land = model_from_reference(jm, device="cpu", dtype=torch.float32)
    Y = state_from_numpy(_np_state(jY), device="cpu", dtype=torch.float32)
    run = ck.make_fused_column_run(land, steps_per_call=4, forcing_fields=("precipitation", "u_atm"),
                                   forcing_time_grid=(7.0, 3.0, 6))
    f = forcing_from_numpy({"precipitation": rows["precipitation"], "u_atm": rows["u_atm"][:, 0]},
                           device="cpu", dtype=torch.float32)
    wide = torch.zeros((6, 2 * jt.NCOL), dtype=torch.float32)
    wide[:, ::2] = f["precipitation"]
    chunk = {"precipitation": wide[:, ::2], "u_atm": f["u_atm"]}  # a strided view, used in place
    r = run._forcing_rows(chunk, jt.NCOL, torch.device("cpu"))
    fields = [Y["soil"][k] for k in run.fields]
    params, zc, dz = run._inputs(jt.NCOL, torch.device("cpu"))[:3]
    tables, profiles, surface, precip = run.tables(jt.NCOL, torch.device("cpu"), 0.1)
    assert precip is None and surface[ck.SURFACE_NAMES.index("u_atm")] is None
    a = ck.kernel_args(land, fields, fields[0], zc, dz, params, tables, 4, 60.0, profiles=profiles,
                       surface=surface, precip=precip, h_s=Y["surface"]["h_s"], forcing=r,
                       forcing_time_grid=run.forcing_time_grid, t0=0.1)
    j = ck.SURFACE_NAMES.index("u_atm")
    assert a.forced == (1 << j) | (1 << len(ck.SURFACE_NAMES)) and a.frow_mode == ck.FROW_TIME
    assert a.precip == wide.data_ptr() and (a.precip_row_stride, a.precip_col_stride) == (2 * jt.NCOL, 2)
    assert a.surface_ptr[j] == f["u_atm"].data_ptr()
    assert (a.surface_row_stride[j], a.surface_col_stride[j]) == (1, 0)
    assert a.n_frows == 6 and a.t_forcing0 == 7.0
    assert a.inv_dt_forcing == float(np.float32(1.0 / 3.0)) and a.t0 == float(np.float32(0.1))
    k = ck.SURFACE_NAMES.index("q_atm")
    assert a.surface_ptr[k] == surface[k][0].data_ptr() and not a.forced & (1 << k)


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_forced_kernel_matches_golden_and_plain(cuda_device, dtype):
    golden = np.load(GOLDEN)
    model, Y, Ya, rows, dt = gct.build_forced_model_state_and_rows(dtype, cuda_device)
    plain, t = Y, torch.tensor(0.0, dtype=dtype)
    for c in range(5):
        plain = ck.fused_column_run_plain(model, SSPRK33(), dt, 8, plain, t,
                                          forcing={k: v[8 * c:8 * c + 8] for k, v in rows.items()})
        t = t + 8 * dt
    seg = make_forced_segment_run(model, SSPRK33(), dt=dt, field_names=sorted(rows), engine="fused",
                                  steps_per_call=8)
    ck.LAUNCHES.clear()
    Yk, _ = seg(Y, Ya, 0.0, rows)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"B5+B7": 5}
    got, want = state_to_numpy(Yk)["soil"], state_to_numpy(plain)["soil"]
    if dtype == torch.float64:
        for k in got:
            np.testing.assert_allclose(got[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-16, err_msg=k)
    else:
        np.testing.assert_allclose(got["vartheta_l"], want["vartheta_l"], rtol=0, atol=2e-4)
        rel = np.abs(got["rho_e_int"] - want["rho_e_int"]) / (np.abs(want["rho_e_int"]) + 1e3)
        assert np.max(rel) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_cuda_run_forced_stages_through_pinned_buffers(cuda_device, tmp_path, overlap):
    """``run_forced`` on the card (float32 file rows staged through pinned
    buffers on a side stream, cast to float64 there) equals the in-memory
    fused segment bit for bit, every launch through the kernel."""
    jm, jY, jYa, rows = _land_case(n_steps=20, seed=4)
    path = str(tmp_path / "forcing.bin")
    write_forcing(path, np.arange(20) * jt.DT, {k: v.astype(np.float32) for k, v in rows.items()})
    model = model_from_reference(jm, device=cuda_device)
    Y, Ya = state_from_numpy(_np_state(jY), device=cuda_device), state_from_numpy(_np_state(jYa), device=cuda_device)
    seg = make_forced_segment_run(model, SSPRK33(), dt=jt.DT, field_names=sorted(rows), engine="fused",
                                  steps_per_call=4)
    Yref, _ = seg(Y, Ya, 0.0, forcing_from_numpy({k: v.astype(np.float32) for k, v in rows.items()},
                                                 device=cuda_device))
    ck.LAUNCHES.clear()
    with ForcingReader(path) as reader:
        Yf, _ = run_forced(model, Y, Ya, reader, SSPRK33(), dt=jt.DT, window=8, engine="fused", steps_per_call=4,
                           overlap=overlap)
        torch.cuda.synchronize()
        assert reader.prefetch_hits > 0
    assert ck.LAUNCHES == {"B6+B7": 6}  # windows of 8, 8, 4 rows
    _close(state_to_numpy(Yf), state_to_numpy(Yref), rtol=0, atol=0)
