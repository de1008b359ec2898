"""The adaptive golden (``tests/data/golden_adaptive_f64.npz``, written by
``tests/data/make_golden_adaptive.py`` with the JAX package) through the
port's drivers, f64 on the CPU (the fused engine through the kernels' plain
version), and the drivers' state handling:

- case a (golden #1 under ``run_adaptive_fused``, SSPRK33 segments of 4
  steps): ``golden_config_torch.check_adaptive_run``;
- case b (the forced golden's soil under ``TRBDF2Soil(iters=2)`` with its
  rows as a time-indexed table): the first ``b_k`` iterations of its
  records replayed through both engines, ``check_adaptive_replay`` (the
  whole case takes minutes through the eager closures on the CPU;
  ``chip_smoke.py`` phase 13 runs it whole through the kernels);
- a rejected iteration leaves the state as it was; ``replay`` follows the
  records it is given; ``golden_config_torch`` rebuilds the JAX tests'
  inputs without JAX.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import numpy as np
import pytest
import torch

from landhydrology_tpu_torch import adaptive as pa
from landhydrology_tpu_torch.convert import state_to_numpy
from tests.data import golden_config_torch as gct
from tests.test_torch_adaptive import GOLDEN, port_case

F64 = torch.float64


def test_golden_case_a_through_the_fused_run():
    """The adaptive golden's case a (golden #1 under run_adaptive_fused,
    segments of 4 SSPRK33 steps, 37 iterations): equal counts and accepted
    count after every iteration, dt within the reference's own one-ulp
    spread, the state at rtol 1e-10."""
    model, Y, Ya, st, kw = gct.build_adaptive_case("a", F64, "cpu")
    log = []
    Yf, stats = pa.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=log, **kw)
    held = gct.check_adaptive_run(GOLDEN, "a", stats, state_to_numpy(Yf)["soil"], log)
    assert held["dt after each iteration (relative)"][0] <= held["dt after each iteration (relative)"][1]


def test_rejected_iterations_leave_the_state_as_it_was(monkeypatch):
    """The fused run updates its state in place; every iteration starts from
    the state the last accepted one left, bit for bit, a rejection included,
    and the caller's state is never written."""
    model, Y, Ya, st, kw = gct.build_adaptive_case("a", F64, "cpu")
    before = state_to_numpy(Y)
    starts = []
    norm = pa._err_norm

    def recording(config, Y1, Y2, Yref):
        starts.append(state_to_numpy(Yref))
        return norm(config, Y1, Y2, Yref)

    monkeypatch.setattr(pa, "_err_norm", recording)
    log = []
    pa.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=log, **kw)
    rejected = [i for i, r in enumerate(log) if not r[3]]
    assert rejected and len(starts) == len(log)
    for i in rejected:
        for k, v in starts[i]["soil"].items():
            np.testing.assert_array_equal(starts[i + 1]["soil"][k], v)
    for k, v in before["soil"].items():
        np.testing.assert_array_equal(state_to_numpy(Y)["soil"][k], v)


def test_replay_follows_the_records_and_logs_its_own_norms():
    """``replay`` takes another run's steps and decisions: replaying a run's
    own log reproduces it bit for bit; a log with a decision flipped ends
    elsewhere."""
    model, Y, Ya, st, kw = gct.build_adaptive_case("a", F64, "cpu")
    log = []
    Yf, stats = pa.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=log, **kw)
    again = []
    Yr, sr = pa.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, log=again, replay=log, **kw)
    assert again == log and int(sr["n_accepted"]) == int(stats["n_accepted"])
    for k, v in state_to_numpy(Yf)["soil"].items():
        np.testing.assert_array_equal(state_to_numpy(Yr)["soil"][k], v)
    flipped = [r if i != len(log) - 2 else (r[0], r[1], r[2], not r[3]) for i, r in enumerate(log)]
    Yx, _ = pa.run_adaptive_fused(model, Y, Ya, 0.0, stepper=st, replay=flipped, **kw)
    assert not np.array_equal(state_to_numpy(Yx)["soil"]["vartheta_l"], state_to_numpy(Yf)["soil"]["vartheta_l"])


@pytest.mark.parametrize("engine", ["torch", "fused"])
def test_golden_case_b_replayed(engine):
    """The adaptive golden's case b: the forced golden's soil under
    TRBDF2Soil(iters=2) with its rows as a time-indexed table, replaying the
    first ``b_k`` iterations of the golden's records: the error norms and
    decisions, and the state after them at rtol 1e-10 (``b_k_*``)."""
    model, Y, Ya, st, kw = gct.build_adaptive_case("b", F64, "cpu")
    records = gct.golden_records(GOLDEN, "b")[:int(GOLDEN["b_k"])]
    log = []
    Yr, _ = pa.run_adaptive_forced(model, Y, Ya, 0.0, stepper=st, engine=engine, steps_per_call=1, log=log,
                                   replay=records, **kw)
    ratio, dev = gct.check_adaptive_replay(GOLDEN, log, state_to_numpy(Yr)["soil"])
    assert ratio <= 1.0 and dev <= 1e-10


def test_golden_adaptive_builders_match_jax():
    """``golden_config_torch``'s builders of the JAX adaptive tests rebuild
    their models, states and rows without JAX: equal to the JAX package's
    converted, and so are the golden's two cases."""
    from tests import test_adaptive as ta

    for name in gct.ADAPTIVE_TESTS:
        model, Y, _, st, kw = gct.build_adaptive_test(name, F64, "cpu")
        case = port_case(name)
        for group, fields in state_to_numpy(case["Y"]).items():
            for k, v in fields.items():
                np.testing.assert_array_equal(state_to_numpy(Y)[group][k], v, err_msg=f"{name}/{group}/{k}")
        for k, v in case.get("forcing", {}).items():
            np.testing.assert_array_equal(kw["forcing"][k], v)
        assert (kw["tf"], kw["dt0"], kw["config"]) == (case["tf"], case["dt0"], case["config"])
        assert kw["steps_per_call"] == (case.get("steps_per_call") or 1)
        assert type(st) is type(case["stepper"]) and getattr(st, "tridiag", None) == getattr(
            case["stepper"], "tridiag", None)
    jland, _, _ = ta._tiny_land()
    land, _, _ = gct.build_tiny_land(F64, "cpu")
    assert (land.surface_update, land.surface.tau_pond) == (jland.surface_update, jland.surface.tau_pond)
