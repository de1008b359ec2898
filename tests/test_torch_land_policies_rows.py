"""The step policies under a MOST top and a LandModel with streamed forcing
rows (kernel mode B7 as a row source of the 30 instances of
``csrc/land_policy_kernel.cu``: ``B5+B3-rate+B7`` to
``B2+B6-step-pond-no-ice+B7``) through the kernel's plain version, against
the JAX package's fused kernel in interpret mode.

- The cases and the bar are ``test_torch_land_policies_b5.py``'s (the cold
  column on ``case_ncol`` columns, JAX's kernel compiled once per case, 2
  steps of 2 s from t0 = 30 s, f64 rtol 1e-12, the equilibrium cases within
  the ulp allowance of ``assert_matches``).
- The rows: per-column ``theta_atm`` within 8 K of 273.15 K under a MOST
  top, and per-column rain rows (0-1.2e-5 m/s) on a LandModel, one row per
  step (``+B7``); on the MOST tops' rate instances also time-indexed rows,
  three rows on a grid of 1.5 s from t = 29.2 s, which the two steps read
  as rows 0 and 1 (``+B7-time``).
- This file holds the MOST tops (B5, B6, B6-step) and the time-indexed
  cases; the plain tops are in ``test_torch_land_policies_rows_pond.py``
  (split so that xdist spreads the interpret-mode runs).

The kernel itself is held against this plain version on the card in
``chip_smoke.py`` phase 17a; the ``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import jax
import numpy as np
import pytest
import torch

from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_pallas_kernel import NCOL
from tests.test_torch_land_policies_b5 import (  # noqa: F401
    DT, STEPS, T0, assert_matches, case_id, case_ncol, cases, cold_state, cuda_device, jax_kernel, jax_model, soil_of,
)

#: the time grid of the time-indexed cases: steps at t0 and t0 + DT read rows 0 and 1
TIME_GRID = (29.2, 1.5, 3)
#: the MOST tops' rate instances, with time-indexed rows
TIME_CASES = [(top, "+B3-rate", False) for top in ("B5", "B6", "B6-step")]


def forcing_rows(top, n_rows, seed=23, ncol=NCOL):
    """The rows of a case: per-column ``theta_atm`` within 8 K of 273.15 K
    under a MOST top, per-column rain under a LandModel (``(n_rows, ncol)``
    each)."""
    rng = np.random.default_rng(seed)
    rows = {}
    if not top.endswith("-pond"):
        rows["theta_atm"] = 273.15 + 8.0 * (2.0 * rng.random((n_rows, ncol)) - 1.0)
    if top != "B5":
        rows["precipitation"] = 1.2e-5 * rng.random((n_rows, ncol))
    return rows


def run_rows_case(top, policy, lagged, icy=False, time_grid=None):
    """The JAX fused kernel (interpret mode) and the port's fused run (its
    plain version on the CPU) on a case with its rows, step-indexed or on
    ``time_grid``; holds the port to JAX (``assert_matches``) and checks the
    run's name.  Returns ``(JAX model, start state, JAX final state)``."""
    ncol = case_ncol(top, policy, lagged)
    jm = jax_model(top, policy, lagged, ncol)
    Y = cold_state(jm, icy)
    rows = forcing_rows(top, STEPS if time_grid is None else time_grid[2], ncol=ncol)
    fields = tuple(rows)
    ref = jax_kernel(top, policy, lagged, ncol, fields, time_grid)(Y, T0, forcing=rows)
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS, forcing_fields=fields,
                                   forcing_time_grid=time_grid)
    name = ("B2+" if lagged else "") + top + policy + ("+B7" if time_grid is None else "+B7-time")
    assert run.name == name
    assert ck._entry(run.mode, torch.float64)[0] == "land_policy_kernel"
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, T0, forcing={k: torch.as_tensor(v) for k, v in rows.items()}) is Yt
    assert ck.LAUNCHES == before
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert_matches(state_to_numpy(Yt), ref, jm)
    return jm, Y, ref


def check_rows_case(top, policy, lagged, time_grid=None):
    """``run_rows_case``, and in the freeze cases that ice formed in some
    cells and melted in others; a no-ice case also on the icy state."""
    _, Y, ref = run_rows_case(top, policy, lagged, time_grid=time_grid)
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    if policy == "-no-ice":
        assert not change.any()
        run_rows_case(top, policy, lagged, icy=True, time_grid=time_grid)
    else:
        assert int((change > 1e-8).sum()) > 100 and int((change < -1e-8).sum()) > 100


@pytest.mark.parametrize("case", cases(("B5", "B6", "B6-step")), ids=case_id)
def test_most_policy_instances_with_rows_match_jax_fused(case):
    check_rows_case(*case)


@pytest.mark.parametrize("case", TIME_CASES, ids=case_id)
def test_most_rate_instances_with_time_indexed_rows_match_jax_fused(case):
    check_rows_case(*case, time_grid=TIME_GRID)


def cuda_rows_match_plain(device, top, policy, lagged, icy=False, time_grid=None):
    """An instance with its rows against its plain version on the card, f64
    at the bar of ``assert_matches``."""
    jm = jax_model(top, policy, lagged)
    rows = {k: torch.as_tensor(v, device=device)
            for k, v in forcing_rows(top, STEPS if time_grid is None else time_grid[2]).items()}
    Y = state_from_numpy(cold_state(jm, icy), device=device)
    model = model_from_reference(jm, device=device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, SSPRK33(), DT, STEPS, Y, T0, forcing=rows,
                                                     forcing_time_grid=time_grid))
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=STEPS, forcing_fields=tuple(rows),
                                   forcing_time_grid=time_grid)
    before = ck.LAUNCHES[run.name]
    run(Y, T0, forcing=rows)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    assert_matches(state_to_numpy(Y), plain, jm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases(("B5", "B6", "B6-step")), ids=case_id)
def test_cuda_most_policy_instances_with_rows_match_plain(cuda_device, case):  # noqa: F811
    cuda_rows_match_plain(cuda_device, *case)
    if case[1] == "-no-ice":
        cuda_rows_match_plain(cuda_device, *case, icy=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", TIME_CASES, ids=case_id)
def test_cuda_most_rate_instances_with_time_indexed_rows_match_plain(cuda_device, case):  # noqa: F811
    cuda_rows_match_plain(cuda_device, *case, time_grid=TIME_GRID)
