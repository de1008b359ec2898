"""The port's error control under streamed forcing
(``run_adaptive_forced``, engines ``"torch"`` and ``"fused"``; the fused
engine through the kernels' plain version), f64 on the CPU, against the
JAX package: the analogues of the adaptive tests of
``tests/test_forcing_driver.py`` (``:345``, ``:398``, ``:428``, ``:457``,
``:478``) against JAX's runs frozen in ``tests/data/golden_adaptive_f64.npz``,
held as ``test_torch_adaptive.py`` holds them (each JAX test's bars, the
free run, the replay of JAX's iteration records).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import numpy as np
import pytest
import torch

from landhydrology_tpu_torch import adaptive as pa
from landhydrology_tpu_torch.convert import state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.data import golden_config_torch as gct
from tests.test_torch_adaptive import GOLDEN, hold_free, hold_replay, port_case, run_port


def test_adaptive_forced_matches_fine_fixed_dt():
    """``test_forcing_driver.py:345``: the pulse rows on a 240 s grid to
    2,880 s, rtol 1e-7, dt_max 60 s, against the rows repeated onto a 30 s
    fixed grid (5e-5 of each field's largest value) and JAX's run."""
    case = port_case("forced_fine")
    Y, stats, _ = run_port(case)
    assert bool(stats["converged"])
    ref = gct.golden_state(GOLDEN, "forced_fine", "fine")["soil"]
    for k, b in ref.items():
        scale = np.max(np.abs(b)) or 1.0
        assert np.max(np.abs(state_to_numpy(Y)["soil"][k] - b)) / scale < 5e-5, k
    hold_free("forced_fine", stats, Y)
    Yr, _, rlog = run_port(case, replay=gct.golden_records(GOLDEN, "forced_fine"))
    hold_replay("forced_fine", case, rlog, Yr)
    # the pulse matters: flattened, the run ends elsewhere
    flat = dict(case, forcing=dict(case["forcing"], theta_atm=np.full(12, 296.0)),
                config=dataclasses.replace(case["config"], dt_max=240.0))
    Yflat, _, _ = run_port(flat)
    assert float(torch.max(torch.abs(Yflat["soil"]["rho_e_int"] - Y["soil"]["rho_e_int"]))) > 0.0


def test_adaptive_forced_fused_matches_xla_engine():
    """``test_forcing_driver.py:398``: the fused engine (time-indexed rows,
    one step per segment) takes JAX's decisions and ends on JAX's state;
    replaying JAX's records, its error norms match."""
    case = port_case("forced_fused")
    Y, stats, _ = run_port(case, "fused")
    hold_free("forced_fused", stats, Y)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "forced_fused"))
    hold_replay("forced_fused", case, log, Yr)


def test_adaptive_forced_fused_segments_accuracy():
    """``test_forcing_driver.py:428``: segments of 4 steps against the fine
    fixed-dt forced reference (2e-5) and JAX's fused run."""
    case = dict(port_case("forced_segments"), steps_per_call=4)
    Y, stats, _ = run_port(case, "fused")
    assert bool(stats["converged"])
    for k, b in gct.golden_state(GOLDEN, "forced_segments", "fine")["soil"].items():
        scale = np.max(np.abs(b)) or 1.0
        assert np.max(np.abs(state_to_numpy(Y)["soil"][k] - b)) / scale < 2e-5, k
    hold_free("forced_segments", stats, Y)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "forced_segments"))
    hold_replay("forced_segments", case, log, Yr)


def test_adaptive_forced_validation():
    """``test_forcing_driver.py:457``."""
    case = port_case("forced_fused")
    with pytest.raises(ValueError, match="forcing_dt"):
        pa.run_adaptive_fused(case["model"], case["Y"], case["Ya"], 0.0, 1.0, 0.1, forcing={"u_atm": np.ones(4)})
    with pytest.raises(ValueError, match="forcing_time_grid"):
        ck.make_fused_column_run(case["model"], dt=1.0, forcing_time_grid=(0.0, 1.0, 4))


def test_adaptive_forced_with_implicit_stepper_both_engines():
    """``test_forcing_driver.py:478``: TR-BDF2 (PCR) under error control and
    time-indexed rows, on both engines (the fused one is kernel mode
    B4-trbdf2-pcr+B5+B7-time): equal to each other bit for bit, JAX's
    decisions, JAX's state at its own bar (rtol 1e-9) on the replay."""
    case = port_case("forced_trbdf2")
    assert ck.make_fused_column_run(case["model"], case["stepper"], forcing_fields=("q_atm", "theta_atm", "u_atm"),
                                    forcing_time_grid=(0.0, 600.0, 6)).name == "B4-trbdf2-pcr+B5+B7-time"
    Yx, sx, lx = run_port(case)
    Yf, sf, lf = run_port(case, "fused")
    assert lx == lf
    for k, v in state_to_numpy(Yx)["soil"].items():
        np.testing.assert_array_equal(state_to_numpy(Yf)["soil"][k], v)
    hold_free("forced_trbdf2", sf, Yf)
    Yr, _, log = run_port(case, "fused", replay=gct.golden_records(GOLDEN, "forced_trbdf2"))
    hold_replay("forced_trbdf2", case, log, Yr, rtol=1e-9)
