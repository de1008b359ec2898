"""Per-column BC kinds and geometry under the implicit steppers with a MOST
top (kernel modes B4+B5 with B1-batched and B8, ``MODE_MOST | MODE_COLUMNS``:
``csrc/implicit_most_columns_kernel.cu``, TR-BDF2, BackwardEulerSoil and
BackwardEulerRichards without a step policy and with each, PCR read at run
time, forcing rows a run-time row source) through the kernel's plain
version, against the JAX package's fused kernel in interpret mode.

- The column: ``test_torch_b4_most_policies.py``'s MOST soil (nz=16 under
  the cold atmosphere, 268-278 K by column with 0.02 of ice) on ``NCOL``
  columns in one tile, with a ``BatchedBC`` bottom for the hydrology (FLUX
  -1e-7 m/s, DIRICHLET 0.30 or FREE_DRAINAGE by column) and for the energy
  (FLUX 0 or DIRICHLET 268-278 K), the top faces the exchange's, and with
  ``+B8`` a ``VariableDepthColumn`` of 0.8-1.2 of its depth
  (``with_jax_most_columns``); 2 steps of dt = 60 s from t0 = 30 s,
  iters=2; ``+B7`` with step-indexed per-column ``theta_atm`` rows.
- f64 at rtol 1e-12 (atol 1e-16; ``assert_matches``' ulp allowance in the
  equilibrium case), the PCR case too; every field the case moves changes
  by more than a thousand times its bar.  A ``BatchedBC`` bottom column of
  kind DIRICHLET gets no diagonal boost in either package (imex.py boosts a
  plain Dirichlet alone).
- Without JAX: each of the 24 modes, with rows and without, takes kinds and
  geometry and names ``implicit_most_columns_kernel``; the source holds the
  24 instances.

The kernel is held against this plain version on the card in
``chip_smoke.py`` phase 21 and by the ``cuda``-marked test here, which skips
without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import BatchedBC as JBatchedBC
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import SoilComponentBC as JSoilComponentBC
from landhydrology_tpu import VariableDepthColumn as JVariableDepth
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.convert import stepper_from_reference
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_b4_most_policies import DT, POLICIES, STEPPERS, STEPS, icy, most_soil
from tests.test_torch_land_policies_b5 import T0, assert_matches, cold_state, cuda_device  # noqa: F401
from tests.test_torch_land_policies_rows import forcing_rows

#: the columns of a case, one tile
NCOL = 16
SOURCE = "implicit_most_columns_kernel"


def with_jax_most_columns(jm, kinds=True, depth=True, seed=5):
    """The MOST soil ``jm`` with per-column kinds at its bottom faces alone
    (the top's are the exchange's): the hydrology FLUX (-1e-7 m/s),
    DIRICHLET (0.30) or FREE_DRAINAGE by column, the energy FLUX (0) or
    DIRICHLET (268-278 K); with ``depth`` a ``VariableDepthColumn`` of
    0.8-1.2 of its depth."""
    rng = np.random.default_rng(seed)
    ncol, nz = jm.domain.batch_shape[0], jm.domain.nelements
    bcs = jm.boundary_conditions
    if kinds:
        kind = jnp.asarray(np.arange(ncol) % 3, dtype=jnp.int32)
        water = JBatchedBC(kind=kind, value=jnp.where(kind == 1, 0.30, -1e-7))
        kind = jnp.asarray((np.arange(ncol) // 2) % 2, dtype=jnp.int32)
        energy = JBatchedBC(kind=kind, value=jnp.where(kind == 1, jnp.asarray(rng.uniform(268.0, 278.0, ncol)), 0.0))
        jm = dataclasses.replace(jm, boundary_conditions=JSoilColumnBC(
            top=bcs.top, bottom=JSoilComponentBC(hydrology=water, energy=energy)))
    if depth:
        z_bottom, z_top = jm.domain.zlim
        jm = dataclasses.replace(jm, domain=JVariableDepth(
            z_bottom=jnp.asarray(z_top - (z_top - z_bottom) * rng.uniform(0.8, 1.2, ncol)), z_top=z_top,
            nelements=nz, batch_shape=(ncol,)))
    return jm


def parse(name):
    """``(stepper key, policy, tridiag, kinds, depth, rows)`` of a mode named
    as the port names its run (``B4-trbdf2-pcr+B2+B3-eq+B5+kinds+B8``,
    ``B4-be-soil-no-ice+B2+B5+kinds+B8+B7``)."""
    m = re.fullmatch(r"B4-(trbdf2|be-soil|be-richards)(.*)\+B5(\+kinds)?(\+B8)?(\+B7)?", name.replace("-pcr", ""))
    assert m, name
    key, policy, kinds, depth, rows = m.groups()
    return key, policy, "pcr" if "-pcr" in name else "thomas", bool(kinds), bool(depth), bool(rows)


def case_model(name):
    """The JAX model of case ``name`` and its cold start state."""
    _, policy, _, kinds, depth, _ = parse(name)
    jm = most_soil(policy, NCOL) if policy else dataclasses.replace(most_soil("+B2", NCOL), coefficient_update="stage")
    jm = with_jax_most_columns(jm, kinds, depth)
    return jm, cold_state(jm)


def jax_stepper(jm, key, tridiag):
    return STEPPERS[key](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2, tridiag=tridiag)


@functools.lru_cache(maxsize=None)
def jax_kernel(name):
    """JAX's fused kernel of a case in interpret mode over one tile, under
    ``jax.jit``: compiled once per process, also for the icy state."""
    key, _, tridiag, _, _, rows = parse(name)
    jm, _ = case_model(name)
    return jax.jit(jax_fused(jm, jax_stepper(jm, key, tridiag), dt=DT, steps_per_call=STEPS, tile_cols=NCOL,
                             interpret=True, forcing_fields=("theta_atm",) if rows else ()))


def check_case(name, state=None):
    """JAX's fused kernel against the port's fused run (its plain version on
    the CPU, no launch) on case ``name`` (from ``state(jm, Y)`` where given):
    the run's name and source, the bar of ``assert_matches``, the moving
    fields; returns ``(JAX model, start state, JAX final state)``."""
    key, _, tridiag, _, _, rows = parse(name)
    jm, Y = case_model(name)
    if state is not None:
        Y = state(jm, Y)
    forcing = forcing_rows("B5", STEPS, ncol=NCOL) if rows else None
    ref = jax.tree_util.tree_map(np.asarray, jax_kernel(name)(Y, T0, forcing=forcing))
    model = model_from_reference(jm, device="cpu")
    st = stepper_from_reference(jax_stepper(jm, key, tridiag), model, device="cpu")
    run = ck.make_fused_column_run(model, st, dt=DT, steps_per_call=STEPS, forcing_fields=tuple(forcing or ()))
    assert run.name == name and ck._entry(run.mode, torch.float64)[0] == SOURCE
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    rows_t = None if forcing is None else {k: torch.as_tensor(v) for k, v in forcing.items()}
    assert run(Yt, T0, forcing=rows_t) is Yt and ck.LAUNCHES == before
    assert_matches(state_to_numpy(Yt), ref, jm)
    start = {k: np.asarray(v) for k, v in Y["soil"].items()}
    for k, v in ref["soil"].items():
        if k == "theta_i" and jm.freeze_thaw is None:
            continue
        change = float(np.max(np.abs(v - start[k])))
        assert change > 1e3 * (1e-12 * float(np.max(np.abs(start[k]))) + 1e-16), (name, k, change)
    return jm, Y, ref


CASES = ("B4-trbdf2+B5+kinds+B8", "B4-be-soil+B5+kinds", "B4-be-richards+B2+B5+B8",
         "B4-trbdf2-pcr+B2+B3-eq+B5+kinds+B8")


@pytest.mark.parametrize("name", CASES)
def test_most_columns_match_jax_fused(name):
    """Each stepper under the MOST top with kinds, depths or both: TR-BDF2
    and BackwardEulerSoil without a policy, BackwardEulerRichards lagged, and
    TR-BDF2 lagged with the equilibrium projection and PCR solves."""
    check_case(name)


def test_rate_freeze_thaw_with_rows_freezes_and_melts():
    """``B4-trbdf2+B3-rate+B5+kinds+B8+B7``: TR-BDF2 with rate freeze-thaw,
    kinds, depths and step-indexed ``theta_atm`` rows; ice grows in some
    cells and melts in others."""
    _, Y, ref = check_case("B4-trbdf2+B3-rate+B5+kinds+B8+B7")
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    assert int((change > 1e-8).sum()) > 10 and int((change < -1e-8).sum()) > 10


def test_no_ice_cap_on_an_icy_state():
    """``B4-be-soil-no-ice+B2+B5+kinds+B8`` on the icy state, where the rhs
    caps theta_l at nu - theta_i (``MODE_RHS_CAP``) and the sweeps keep the
    state's ice."""
    jm, Y, _ = check_case("B4-be-soil-no-ice+B2+B5+kinds+B8", state=icy)
    soil = {k: np.asarray(v) for k, v in Y["soil"].items()}
    assert np.any(soil["vartheta_l"] > np.asarray(jm.soil_param_set.nu) - soil["theta_i"])


# ---- every mode, without JAX ----


def mode_names():
    """The 24 modes with kinds and depths, as the port names its run: each
    stepper without a policy and with each of the seven."""
    return [f"B4-{st}{p}+B5+kinds+B8" for st in STEPPERS for p in ("",) + tuple(POLICIES)]


def test_every_most_implicit_mode_takes_kinds_and_geometry():
    """Each of the 24 modes builds a run with kinds and depths, with
    step-indexed rows and without, from ``implicit_most_columns_kernel``:
    24 distinct instances, PCR read at run time."""
    instances = set()
    for name in mode_names():
        key, _, _, _, _, _ = parse(name)
        jm, _ = case_model(name)
        model = model_from_reference(jm, device="cpu")
        for tridiag in ("thomas", "pcr"):
            st = stepper_from_reference(jax_stepper(jm, key, tridiag), model, device="cpu")
            for rows in ((), ("theta_atm",)):
                run = ck.make_fused_column_run(model, st, dt=DT, forcing_fields=rows)
                head, plus, tail = name.partition("+")  # -pcr after the stepper and -no-ice
                want = f"{head}-pcr{plus}{tail}" if tridiag == "pcr" else name
                assert run.name == want + ("+B7" if rows else "") and ck.takes_per_column(run.mode)
                assert ck._entry(run.mode, torch.float32)[0] == SOURCE, run.name
                assert ck._entry(run.mode, torch.float64)[1] == f"{SOURCE}_f64"
                instances.add(run.mode & ~ck.MODE_PCR)
    assert len(instances) == 24


def test_most_columns_source_instantiates_its_modes():
    """``implicit_most_columns_kernel.cu``: the three steppers under
    ``MODE_MOST | MODE_COLUMNS`` without a policy and ``POLICY_CASES`` on
    each (the no-ice instance with ``MODE_RHS_CAP``): 24 instances per
    float type."""
    src = (ck.CSRC / "implicit_most_columns_kernel.cu").read_text()
    body = (ck.CSRC / "implicit_column.cuh").read_text()
    macro = body[body.index("#define POLICY_CASES(S)"):body.index("#define WATER_POLICY_CASES")]
    assert macro.count("case S |") == 7 and "S | MODE_NO_ICE | MODE_RHS_CAP>" in macro
    for st in ("MODE_TRBDF2", "MODE_BE_RICHARDS", "MODE_BE_SOIL"):
        assert f"POLICY_CASES({st} | MODE_MOST | MODE_COLUMNS)" in src
        assert f"case {st} | MODE_MOST | MODE_COLUMNS:" in src
    assert src.count("POLICY_CASES(") == 3 and src.count("    case MODE_") == 3


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B4-trbdf2+B5+kinds+B8", "B4-trbdf2+B3-rate+B5+kinds+B8+B7",
                                  "B4-be-soil-no-ice+B2+B5+kinds+B8", "B4-be-richards+B2+B5+B8"])
def test_cuda_most_columns_instances_match_plain(cuda_device, name):  # noqa: F811
    """A launch of ``implicit_most_columns_kernel.cu``'s instances against the
    plain version on the card, f64 at the bar of ``assert_matches``."""
    key, _, tridiag, _, _, rows = parse(name)
    jm, Y0 = case_model(name)
    model = model_from_reference(jm, device=cuda_device)
    st = stepper_from_reference(jax_stepper(jm, key, tridiag), model, device=cuda_device)
    forcing = None
    if rows:
        forcing = {k: torch.as_tensor(v, device=cuda_device) for k, v in forcing_rows("B5", STEPS, ncol=NCOL).items()}
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, DT, STEPS, state_from_numpy(Y0, device=cuda_device),
                                                     T0, forcing=forcing))
    run = ck.make_fused_column_run(model, st, dt=DT, steps_per_call=STEPS, forcing_fields=tuple(forcing or ()))
    Y = state_from_numpy(Y0, device=cuda_device)
    before = ck.LAUNCHES[run.name]
    run(Y, T0, forcing=forcing)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1 and ck._entry(run.mode, torch.float64)[0] == SOURCE
    assert_matches(state_to_numpy(Y), plain, jm)
