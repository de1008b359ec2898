"""The implicit steppers with the step policies under a MOST top (kernel modes
B4+B5 with B2, B3 and no ice, ``csrc/implicit_most_kernel.cu``) and with
lagged coefficients and ``assume_no_ice`` on the plain soil
(``csrc/implicit_policy_kernel.cu``) through the kernel's plain version, against
the JAX package's fused kernel in interpret mode.

- The MOST column: ``test_torch_land_policies_b5.py``'s B5 soil (nz=16
  under a cold atmosphere, 268-278 K with 0.02 of ice, rate freeze-thaw at
  tau = 60 s) on ``CHECK_NCOL`` columns in one tile (``FULL_CASES``: 256
  in two tiles of 128), 2 steps of dt = 60 s from t0 = 30 s, iters=2, Thomas
  solves, JAX's kernel of a case compiled once (``jax_kernel``, also for
  the icy state); each of ``TRBDF2Soil``, ``BackwardEulerSoil``
  and ``BackwardEulerRichards`` with the seven policy settings (``+B2``,
  ``+B3-rate``, ``+B3-eq``, ``-no-ice``, ``+B2+B3-rate``, ``+B2+B3-eq``,
  ``-no-ice+B2``); TR-BDF2 with rate and with lagged equilibrium
  freeze-thaw also with per-column ``theta_atm`` rows, step-indexed (B7) and
  time-indexed (B7-time).
- The plain soil: ``test_torch_b4_policies.py``'s golden #1 case (nz=24 x
  8, 2 steps of dt = 120 s) with lagged coefficients and no ice.
- The bar: rtol 1e-12 (atol 1e-16), and ``assert_matches``' ulp allowance
  for the equilibrium cases.  Freeze cases: theta_i grows in some cells and
  shrinks in others.  No-ice cases also run on the icy state (theta_i 0.05
  and vartheta_l = nu - 0.02 in the lower half), where the rhs's cap of
  theta_l matters.

This file holds the builders and TR-BDF2's cases without rows; its cases
with rows are in ``test_torch_b4_most_policies_rows.py`` and the backward
Euler steppers' in ``test_torch_b4_most_policies_be_soil.py`` and
``test_torch_b4_most_policies_be_richards.py`` (split so that xdist spreads
the interpret-mode runs, 7-30 s each here).  The kernel is held
against this plain version on the card in ``chip_smoke.py`` phase 17a; the
``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import BackwardEulerRichards as JBER
from landhydrology_tpu.imex import BackwardEulerSoil as JBES
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JRate
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.convert import stepper_from_reference
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.data import golden_config as gc
from tests.test_pallas_kernel import NCOL
from tests.test_torch_land_policies_b5 import (  # noqa: F401
    CHECK_NCOL, T0, assert_matches, cold_state, cuda_device, jax_model, tile_of,
)
from tests.test_torch_land_policies_rows import TIME_GRID, forcing_rows

#: the policy settings: the mode name's suffix (before ``+B5``) and the soil's options
POLICIES = {
    "+B2": {"coefficient_update": "step"},
    "+B3-rate": {"freeze_thaw": JRate(tau=60.0)},
    "+B3-eq": {"freeze_thaw": JEq()},
    "-no-ice": {"assume_no_ice": True},
    "+B2+B3-rate": {"coefficient_update": "step", "freeze_thaw": JRate(tau=60.0)},
    "+B2+B3-eq": {"coefficient_update": "step", "freeze_thaw": JEq()},
    "-no-ice+B2": {"coefficient_update": "step", "assume_no_ice": True},
}
STEPPERS = {"trbdf2": JTRBDF2, "be-soil": JBES, "be-richards": JBER}
DT, STEPS = 60.0, 2
#: the settings with rows (TR-BDF2): step-indexed and time-indexed
ROW_POLICIES = ("+B3-rate", "+B2+B3-eq")
#: the MOST cases (stepper, policy) that keep test_pallas_kernel.py's 256 columns in two tiles of 128
FULL_CASES = frozenset({("be-richards", "+B2")})


def case_id(case):
    return "B4-" + "".join(str(p) for p in case[:2] if p) + ("+B5" if len(case) < 3 or case[2] else "")


def most_soil(policy, ncol=NCOL):
    """The JAX MOST soil column of a policy setting on ``ncol`` columns: the
    B5 column of the land policy tests without its own policy, then the
    setting's options."""
    soil = jax_model("B5", "-no-ice", False, ncol)
    soil = dataclasses.replace(soil, assume_no_ice=False, freeze_thaw=None, coefficient_update="stage")
    return dataclasses.replace(soil, **POLICIES[policy])


def plain_soil():
    """The JAX plain soil column with lagged coefficients and no ice, its
    start state, dt and steps: golden #1 as ``test_torch_b4_policies.py``
    builds it."""
    model, Y, _, _ = gc.build_model_and_state(jnp.float64)
    return dataclasses.replace(model, coefficient_update="step", assume_no_ice=True), Y, 120.0, 2


def icy(jm, Y):
    """``Y`` with theta_i 0.05 and vartheta_l = nu - 0.02 in the lower half."""
    soil = {k: np.array(v) for k, v in Y["soil"].items()}
    half = soil["theta_i"].shape[0] // 2
    soil["theta_i"][:half] = 0.05
    soil["vartheta_l"][:half] = np.asarray(jm.soil_param_set.nu, dtype=np.float64) - 0.02
    return {"soil": {k: jnp.asarray(v) for k, v in soil.items()}}


def case_model(stepper, policy, most=True):
    """``(JAX model, start state, dt, steps)`` of a case: the MOST soil on
    ``CHECK_NCOL`` columns (256 for ``FULL_CASES``), or the plain soil."""
    if most:
        jm = most_soil(policy, NCOL if (stepper, policy) in FULL_CASES else CHECK_NCOL)
        return jm, cold_state(jm), DT, STEPS
    return plain_soil()


@functools.lru_cache(maxsize=None)
def jax_kernel(stepper, policy, most=True, fields=(), time_grid=None):
    """JAX's fused kernel of a case in interpret mode (one tile up to 128
    columns), under ``jax.jit``: compiled once per process, also for the icy
    state."""
    jm, Y, dt, n = case_model(stepper, policy, most)
    jst = STEPPERS[stepper](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    return jax.jit(jax_fused(jm, jst, dt=dt, steps_per_call=n, tile_cols=tile_of(jm.domain.batch_shape[0]),
                             interpret=True, forcing_fields=fields, forcing_time_grid=time_grid))


def run_implicit_case(stepper, policy, most=True, icy_state=False, time_grid=None, rows=False):
    """JAX's fused kernel in interpret mode against the port's fused run (its
    plain version on the CPU) on one case; checks the mode name and the
    source, holds the port to JAX (``assert_matches``) and returns ``(JAX
    model, start state, JAX final state)``."""
    jm, Y, dt, n = case_model(stepper, policy, most)
    if icy_state:
        Y = icy(jm, Y)
    jst = STEPPERS[stepper](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    ncol = jm.domain.batch_shape[0]
    forcing = forcing_rows("B5", n if time_grid is None else time_grid[2], ncol=ncol) if rows else None
    fields = tuple(forcing or ())
    ref = jax_kernel(stepper, policy, most, fields, time_grid)(Y, T0, forcing=forcing)
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, stepper_from_reference(jst, model, device="cpu"), dt=dt,
                                   steps_per_call=n, forcing_fields=fields, forcing_time_grid=time_grid)
    suffix = "" if not rows else "+B7" if time_grid is None else "+B7-time"
    assert run.name == f"B4-{stepper}{policy}" + ("+B5" if most else "") + suffix
    assert ck._entry(run.mode, torch.float64)[0] == ("implicit_most_kernel" if most else "implicit_policy_kernel")
    Yt = state_from_numpy(Y, device="cpu")
    run(Yt, T0, forcing=None if forcing is None else {k: torch.as_tensor(v) for k, v in forcing.items()})
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert_matches(state_to_numpy(Yt), ref, jm)
    return jm, Y, ref


def check_implicit_case(stepper, policy, most=True, **kw):
    """``run_implicit_case``; in the freeze cases ice must grow in some cells
    and melt in others; a no-ice case runs on the icy state too."""
    _, Y, ref = run_implicit_case(stepper, policy, most, **kw)
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    if "no-ice" in policy:
        run_implicit_case(stepper, policy, most, icy_state=True, **kw)
    elif "B3" in policy:
        assert int((change > 1e-8).sum()) > 50 and int((change < -1e-8).sum()) > 50


def cases(stepper):
    """``(stepper, policy, most)`` of one stepper: the seven settings under
    MOST, lagged with no ice on the plain soil."""
    return [(stepper, p, True) for p in POLICIES] + [(stepper, "-no-ice+B2", False)]


@pytest.mark.parametrize("case", cases("trbdf2"), ids=case_id)
def test_trbdf2_policies_match_jax_fused(case):
    check_implicit_case(*case)


def test_most_policy_mode_words_names_and_scratch():
    """The 21 MOST instances and the 3 plain-soil ones: distinct names by
    ``mode_name``'s rules, their sources, the lagged coefficients' scratch
    after the solver's fields."""
    from landhydrology_tpu_torch.domains import make_function_space

    names = set()
    for stepper in STEPPERS:
        for _, policy, most in cases(stepper):
            model = model_from_reference(most_soil(policy) if most else plain_soil()[0], device="cpu")
            grid = make_function_space(model.domain, torch.float64, "cpu")
            st = {"trbdf2": "TRBDF2Soil", "be-soil": "BackwardEulerSoil", "be-richards": "BackwardEulerRichards"}
            import landhydrology_tpu_torch.imex as imex

            run = ck.make_fused_column_run(model, getattr(imex, st[stepper])(model=model, grid=grid))
            assert run.name == f"B4-{stepper}{policy}" + ("+B5" if most else "") and run.name not in names
            names.add(run.name)
            assert ck._entry(run.mode, torch.float32)[0] == ("implicit_most_kernel" if most
                                                             else "implicit_policy_kernel")
            lagged = 5 if "+B2+B3-rate" in policy else 4 if "B2" in policy else 0
            assert ck.scratch_fields(run.mode) == 11 + lagged
    assert len(names) == 24


def cuda_implicit_matches_plain(device, stepper, policy, most=True, icy_state=False, rows=False, time_grid=None):
    """A case's instance against its plain version on the card, f64 at the
    bar of ``assert_matches``."""
    if most:
        jm, dt, n = most_soil(policy), DT, STEPS
        Y = cold_state(jm)
    else:
        jm, Y, dt, n = plain_soil()
    if icy_state:
        Y = icy(jm, Y)
    model = model_from_reference(jm, device=device)
    st = stepper_from_reference(STEPPERS[stepper](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2),
                                model)
    forcing = None
    if rows:
        forcing = {k: torch.as_tensor(v, device=device)
                   for k, v in forcing_rows("B5", n if time_grid is None else time_grid[2]).items()}
    Yt = state_from_numpy(Y, device=device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, dt, n, Yt, T0, forcing=forcing,
                                                     forcing_time_grid=time_grid))
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n, forcing_fields=tuple(forcing or ()),
                                   forcing_time_grid=time_grid)
    before = ck.LAUNCHES[run.name]
    run(Yt, T0, forcing=forcing)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    assert_matches(state_to_numpy(Yt), plain, jm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases("trbdf2"), ids=case_id)
def test_cuda_trbdf2_policy_instances_match_plain(cuda_device, case):  # noqa: F811
    cuda_implicit_matches_plain(cuda_device, *case)
    if "no-ice" in case[1]:
        cuda_implicit_matches_plain(cuda_device, *case, icy_state=True)
