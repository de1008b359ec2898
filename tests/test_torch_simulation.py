"""The PyTorch port's ``Simulation`` against the JAX package's, and golden
#1 end to end.

- engine ``"torch"`` vs the JAX ``"xla"`` engine and engine ``"fused"`` (the
  kernel's plain version on the CPU) vs the JAX ``"pallas"`` engine
  (interpret mode): saved times, saved states, the ``rem`` tail and
  callbacks, at rtol 1e-13 (eager) and 1e-12 (fused);
- golden #1 at rtol 1e-13 in float64 and at the loose float32 bar;
- the implicit steppers through both engines, and the fused engine's
  checks of them;
- ``tests/data/golden_config_torch.py`` reproduces the JAX configuration's model
  and state without JAX, and the package imports no JAX.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import Simulation as JSimulation
from landhydrology_tpu.diagnostics import energy_total as j_energy_total
from landhydrology_tpu.diagnostics import explicit_dt_limit as j_explicit_dt_limit
from landhydrology_tpu.diagnostics import water_mass as j_water_mass
from landhydrology_tpu.models.soil.initial_conditions import (
    default_initial_conditions as j_default_ic,
)
from landhydrology_tpu.timestepping import SSPRK33 as JSSPRK33
from landhydrology_tpu_torch import Simulation
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.diagnostics import energy_total, explicit_dt_limit, water_mass
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_coupled_f64.npz")
FIELDS = ("vartheta_l", "theta_i", "rho_e_int")


def _np_sol(sol):
    return np.asarray(sol.ts), {k: np.asarray(sol.us["soil"][k]) for k in FIELDS}


def _assert_solutions_equal(port_sol, jax_sol, rtol):
    ts, us = _np_sol(port_sol)
    jts, jus = _np_sol(jax_sol)
    np.testing.assert_array_equal(ts, jts)
    for k in FIELDS:
        np.testing.assert_allclose(us[k], jus[k], rtol=rtol, atol=1e-18, err_msg=k)


def _port_case(dtype=torch.float64):
    jm, Y, Ya, dt = gc.build_model_and_state(jnp.float64)
    return model_from_reference(jm, dtype=dtype, device="cpu"), state_from_numpy(Y, dtype=dtype, device="cpu"), jm, Y, Ya, dt


@pytest.mark.parametrize("tspan,saveat", [((0.0, 640.0), 160.0), ((0.0, 250.0), 100.0)],
                         ids=["whole_intervals", "rem_tail"])
def test_torch_engine_matches_jax_xla_engine(tspan, saveat):
    model, Yt, jm, Y, Ya, dt = _port_case()
    jsol = JSimulation(jm, JSSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=tspan, saveat=saveat).run()
    sim = Simulation(model, SSPRK33(), Y_init=Yt, dt=dt, tspan=tspan, saveat=saveat)
    sol = sim.run()
    _assert_solutions_equal(sol, jsol, rtol=1e-13)
    assert sim.t == tspan[1] and len(sol) == len(jsol)
    # the initial state is saved first and left untouched
    np.testing.assert_array_equal(state_to_numpy(Yt)["soil"]["vartheta_l"], np.asarray(Y["soil"]["vartheta_l"]))


def test_fused_engine_matches_jax_pallas_engine():
    """25 steps saved every 10 (steps_per_call 4 -> 2 by the divisor rule)
    plus a 5-step tail in one fused call, as the JAX engine splits them."""
    model, Yt, jm, Y, Ya, dt = _port_case()
    kw = dict(dt=dt, tspan=(0.0, 250.0), saveat=100.0, engine="fused", steps_per_call=4)
    jkw = dict(kw, engine="pallas")
    jsol = JSimulation(jm, JSSPRK33(), Y_init=Y, Ya_init=Ya, **jkw).run()
    sim = Simulation(model, SSPRK33(), Y_init=Yt, **kw)
    sol = sim.run()
    _assert_solutions_equal(sol, jsol, rtol=1e-12)
    assert sorted(sim._fused_runs) == [1, 2, 5]


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_callbacks_match_jax(engine):
    """A host callback at every save point sees (Y, t) and may replace the
    state; the JAX run with the same callback is the reference."""
    model, Yt, jm, Y, Ya, dt = _port_case()
    seen, jseen = [], []

    def make_cb(log):
        def cb(Y, t):
            log.append(t)
            if len(log) == 1:
                soil = dict(Y["soil"], vartheta_l=Y["soil"]["vartheta_l"] * 0.99)
                return {"soil": soil}
            return None

        return cb

    kw = dict(dt=dt, tspan=(0.0, 250.0), saveat=100.0, steps_per_call=4)
    jsol = JSimulation(jm, JSSPRK33(), Y_init=Y, Ya_init=Ya, callbacks=[make_cb(jseen)], **kw).run()
    sol = Simulation(model, SSPRK33(), Y_init=Yt, callbacks=[make_cb(seen)], engine=engine, **kw).run()
    assert seen == jseen == [100.0, 200.0]
    _assert_solutions_equal(sol, jsol, rtol=1e-12)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_golden_f64(engine):
    model, Y, Ya, dt = gct.build_model_and_state(torch.float64, "cpu")
    sol = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, gct.N_STEPS * dt),
                     engine=engine, steps_per_call=16).run()
    golden = np.load(GOLDEN)
    assert float(sol.ts[-1]) == float(golden["t"])
    final = state_to_numpy(sol.state(-1))["soil"]
    for k in FIELDS:
        np.testing.assert_allclose(final[k], golden[k], rtol=1e-13, atol=1e-18, err_msg=k)


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_golden_f32_loose(engine):
    model, Y, Ya, dt = gct.build_model_and_state(torch.float32, "cpu")
    sol = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, gct.N_STEPS * dt),
                     engine=engine, steps_per_call=32).run()
    assert sol.ts.dtype == torch.float32
    final = state_to_numpy(sol.state(-1))["soil"]
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(final["vartheta_l"], golden["vartheta_l"], rtol=0, atol=2e-4)
    rel = np.abs(final["rho_e_int"].astype(np.float64) - golden["rho_e_int"]) / (np.abs(golden["rho_e_int"]) + 1e3)
    assert np.max(rel) < 5e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_golden_config_torch_reproduces_jax_config(dtype):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jm, Y, Ya, dt = gc.build_model_and_state(jdtype)
    model, Yt, Yat, dtt = gct.build_model_and_state(dtype, "cpu")
    assert dt == dtt and (gct.NZ, gct.NCOL, gct.N_STEPS) == (gc.NZ, gc.NCOL, gc.N_STEPS)
    for k in FIELDS:
        got = Yt["soil"][k]
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(Y["soil"][k]), err_msg=k)
    np.testing.assert_array_equal(Yat["zc"].numpy(), np.asarray(Ya["zc"]))
    ref = model_from_reference(jm, dtype=dtype, device="cpu")
    for a, b in ((model.soil_param_set, ref.soil_param_set),
                 (model.hydrology_model.hydraulic_model, ref.hydrology_model.hydraulic_model)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            assert type(va) is type(vb), f.name
            assert torch.equal(va, vb) if torch.is_tensor(va) else va == vb, f.name
    assert model.earth_param_set == ref.earth_param_set
    assert model.domain == ref.domain and model.dtype == ref.dtype
    for face in ("top", "bottom"):
        for comp in ("energy", "hydrology"):
            a = getattr(getattr(model.boundary_conditions, face), comp)
            b = getattr(getattr(jm.boundary_conditions, face), comp)
            assert type(a).__name__ == type(b).__name__
            for f in ("state_value", "flux"):
                if hasattr(a, f):
                    va, vb = getattr(a, f), getattr(b, f)
                    t = torch.tensor(10.0, dtype=torch.float64)
                    assert float(va(t) if callable(va) else va) == float(vb(10.0) if callable(vb) else vb)


def test_step_matches_jax_step():
    model, Yt, jm, Y, Ya, dt = _port_case()
    sim = Simulation(model, SSPRK33(), Y_init=Yt, dt=dt, tspan=(0.0, 100.0))
    jsim = JSimulation(jm, JSSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, 100.0))
    for _ in range(2):
        sim.step()
        jsim.step()
    assert sim.t == jsim.t == 2 * dt
    for k in FIELDS:
        np.testing.assert_allclose(sim.Y["soil"][k].numpy(), np.asarray(jsim.Y["soil"][k]), rtol=1e-13, atol=1e-18)


def test_default_initial_conditions_match_jax():
    model, _, jm, _, _, _ = _port_case()
    sim = Simulation(model, SSPRK33(), dt=1.0, tspan=(0.0, 1.0))
    JY, _ = j_default_ic(jm)
    for k in FIELDS:
        np.testing.assert_allclose(sim.Y["soil"][k].numpy(), np.asarray(JY["soil"][k]), rtol=1e-15, err_msg=k)


def test_diagnostics_match_jax():
    model, Yt, jm, Y, _, _ = _port_case()
    dz = 1.2 / gc.NZ
    np.testing.assert_allclose(float(water_mass(Yt, dz)), float(j_water_mass(Y, dz)), rtol=1e-14)
    np.testing.assert_allclose(float(energy_total(Yt, dz)), float(j_energy_total(Y, dz)), rtol=1e-14)
    np.testing.assert_allclose(float(explicit_dt_limit(model, Yt)), float(j_explicit_dt_limit(jm, Y)), rtol=1e-12)


def test_cfl_warning_and_unported_options():
    model, Yt, *_ = _port_case()
    with pytest.warns(RuntimeWarning, match="CFL"):
        Simulation(model, SSPRK33(), Y_init=Yt, dt=1e6, tspan=(0.0, 1e6))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim = Simulation(model, SSPRK33(), Y_init=Yt, dt=10.0, tspan=(0.0, 10.0))
    with pytest.raises(NotImplementedError, match="sink"):
        sim.run(sink=object())
    with pytest.raises(ValueError, match="engine"):
        Simulation(model, SSPRK33(), Y_init=Yt, dt=10.0, tspan=(0.0, 10.0), engine="pallas")


def test_package_imports_no_jax():
    """Importing the port (and building golden #1 with it, as chip_smoke.py
    does) leaves JAX and the JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "import landhydrology_tpu_torch, landhydrology_tpu_torch.convert\n"
        "import landhydrology_tpu_torch.ops.cuda.column_kernel, landhydrology_tpu_torch.diagnostics\n"
        "import chip_smoke\n"
        "from tests.data import golden_config_torch as g\n"
        "m, Y, Ya, dt = g.build_model_and_state(torch.float64, 'cpu')\n"
        "landhydrology_tpu_torch.Simulation(m, Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0, 2 * dt)).run()\n"
        "grid = landhydrology_tpu_torch.make_function_space(m.domain, torch.float64, 'cpu')\n"
        "st = landhydrology_tpu_torch.TRBDF2Soil(m, grid, 2, 'pcr')\n"
        "landhydrology_tpu_torch.Simulation(m, st, Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0, 2 * dt), engine='fused').run()\n"
        "land, Y, Ya, dt = g.build_land_model_and_state(torch.float64, 'cpu')\n"
        "landhydrology_tpu_torch.Simulation(land, Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0, dt)).run()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'landhydrology_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104"])
def test_steppers_match_jax(name):
    """Each explicit stepper of the port == the JAX stepper of that name,
    three steps on golden #1 from t0 = 5."""
    import landhydrology_tpu.timestepping as jts
    import landhydrology_tpu_torch.timestepping as tts
    from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
    from landhydrology_tpu_torch.models.soil.rhs import make_rhs

    model, Yt, jm, Y, Ya, dt = _port_case()
    jrhs, rhs = jax_make_rhs(jm), make_rhs(model)
    Yat = state_from_numpy(Ya, device="cpu")
    jstep, step = getattr(jts, name)(), getattr(tts, name)()
    dt_t = torch.tensor(dt, dtype=torch.float64)
    for i in range(3):
        t = 5.0 + i * dt
        Y = jstep.step(jrhs, Y, Ya, jnp.asarray(t), jnp.asarray(dt))
        Yt = step.step(rhs, Yt, Yat, torch.tensor(t, dtype=torch.float64), dt_t)
    for k in FIELDS:
        np.testing.assert_allclose(Yt["soil"][k].numpy(), np.asarray(Y["soil"][k]), rtol=1e-13, atol=1e-18, err_msg=k)


def test_entry_points_default_to_the_card():
    """SoilModel, make_function_space, model_from_reference, state_from_numpy
    and the golden builders name CUDA unless the caller asks for the CPU;
    without a GPU, building tensors on that default raises (there is no
    silent CPU path)."""
    import inspect

    from landhydrology_tpu_torch import Column, SoilModel, make_function_space

    model = SoilModel(domain=Column(zlim=(-1.0, 0.0), nelements=4, batch_shape=(2,)))
    assert model.device == "cuda"
    for fn in (make_function_space, model_from_reference, state_from_numpy,
               gct.build_model_and_state, gct.build_freeze_model_and_state, gct.build_land_model_and_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    jm = gc.build_model_and_state(jnp.float64)[0]
    attempts = (
        lambda: model.default_initial_conditions()[0]["soil"]["vartheta_l"],
        lambda: make_function_space(model.domain).zc,
        lambda: model_from_reference(jm).soil_param_set.nu,
        lambda: state_from_numpy({"soil": {"vartheta_l": np.zeros((4, 2))}})["soil"]["vartheta_l"],
    )
    for attempt in attempts:
        if torch.cuda.is_available():
            assert attempt().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                attempt()


def test_sources_name_no_jax():
    """No source of the package, nor chip_smoke.py, imports JAX or the JAX
    package (the port keeps its own copies)."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|landhydrology_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "landhydrology_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.mark.parametrize("name", ["TRBDF2Soil", "BackwardEulerRichards", "BackwardEulerSoil"])
def test_fused_engine_runs_implicit_steppers(name):
    """The implicit steppers through engine "fused" (the kernel's plain
    version on the CPU) == engine "torch", saved states at rtol 1e-12; the
    stepper's grid is rebuilt (here from a float32 grid) on the run's."""
    import landhydrology_tpu_torch.imex as imex
    from landhydrology_tpu_torch import make_function_space

    model, Y, Ya, _ = gct.build_model_and_state(torch.float64, "cpu")
    grid32 = make_function_space(model.domain, torch.float32, "cpu")
    st = getattr(imex, name)(model=model, grid=grid32, iters=2, tridiag="pcr")
    kw = dict(Y_init=Y, Ya_init=Ya, dt=120.0, tspan=(0.0, 840.0), saveat=240.0)
    eager = Simulation(model, st, **kw)
    fused = Simulation(model, st, engine="fused", steps_per_call=2, **kw)
    assert eager.stepper.grid.zc.dtype == torch.float64 and eager.stepper.grid is not grid32
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no CFL warning: unconditionally stable
        Simulation(model, st, **kw)
    se, sf = eager.run(), fused.run()
    assert sorted(fused._fused_runs) == [1, 2]
    np.testing.assert_array_equal(sf.ts.numpy(), se.ts.numpy())
    for k in FIELDS:
        np.testing.assert_allclose(sf.us["soil"][k].numpy(), se.us["soil"][k].numpy(), rtol=1e-12, atol=1e-18)
    assert float(np.max(np.abs(sf.us["soil"]["vartheta_l"][-1].numpy() - sf.us["soil"]["vartheta_l"][0].numpy()))) > 1e-3


def test_fused_engine_requires_the_steppers_model():
    import landhydrology_tpu_torch.imex as imex
    from landhydrology_tpu_torch import make_function_space

    model, Y, Ya, _ = gct.build_model_and_state(torch.float64, "cpu")
    other = dataclasses.replace(model)
    st = imex.TRBDF2Soil(model=other, grid=make_function_space(model.domain, torch.float64, "cpu"))
    Simulation(model, st, Y_init=Y, Ya_init=Ya, dt=120.0, tspan=(0.0, 240.0))  # the eager engine takes it
    with pytest.raises(ValueError, match="run's model"):
        Simulation(model, st, Y_init=Y, Ya_init=Ya, dt=120.0, tspan=(0.0, 240.0), engine="fused")


def test_land_simulation_matches_jax_and_warns_on_the_soil():
    """A LandModel through the eager engine == the JAX ``Simulation`` (xla
    engine) with the frozen exchange and lagged coefficients, saved states
    and pond at rtol 1e-13; the CFL warning reads the soil."""
    from tests.test_torch_land import _jax_land, _jax_land_state

    jm = _jax_land(surface_update="step", coefficient_update="step")
    Y, Ya = _jax_land_state(jm, 1e-5)
    kw = dict(dt=2.0, tspan=(0.0, 8.0), saveat=4.0)
    jsol = JSimulation(jm, JSSPRK33(), Y_init=Y, Ya_init=Ya, **kw).run()
    model = model_from_reference(jm, device="cpu")
    sim = Simulation(model, SSPRK33(), Y_init=state_from_numpy(Y, device="cpu"),
                     Ya_init=state_from_numpy(Ya, device="cpu"), **kw)
    sol = sim.run()
    np.testing.assert_array_equal(sol.ts.numpy(), np.asarray(jsol.ts))
    for group in ("soil", "surface"):
        for k, v in jsol.us[group].items():
            np.testing.assert_allclose(sol.us[group][k].numpy(), np.asarray(v), rtol=1e-13, atol=1e-18,
                                       err_msg=f"{group}/{k}")
    with pytest.warns(RuntimeWarning, match="CFL"):
        Simulation(model, SSPRK33(), Y_init=state_from_numpy(Y, device="cpu"), dt=1e8, tspan=(0.0, 1e8))
