"""Per-column BC kinds and geometry in the plain-soil modes under the implicit
steppers (kernel modes B1-batched and B8 with ``MODE_COLUMNS``:
``csrc/implicit_columns_kernel.cu``'s BackwardEulerSoil and step-policy
instances, on the coupled and water-only branches, and
``csrc/implicit_kernel.cu``'s TR-BDF2 and BackwardEulerRichards, PCR read at
run time) through the kernel's plain version, against the JAX package's
fused kernel in interpret mode.

- The columns of ``test_torch_columns_rk.py`` (golden #1's soil, or the
  freeze column for the freeze cases), with its ``BatchedBC`` hydrology
  bottom and energy top and per-column depths where the name carries
  ``+B8``; 2 steps of dt = 60 s (the freeze column) or 120 s (golden #1),
  iters=2.
- f64 at rtol 1e-12 (atol 1e-16; the equilibrium case within
  ``assert_matches``' ulp allowance), PCR too (within the 1e-9 its kernel is
  held to on the card); every field the case moves changes by more than its
  bar.  A ``BatchedBC`` column of kind
  DIRICHLET gets no diagonal boost in either package (imex.py boosts a plain
  Dirichlet alone).
- Without JAX: every implicit mode on the plain soil takes kinds and
  geometry and names its source, and so does each stepper under a MOST top
  (``implicit_most_columns_kernel``; its cases against JAX are in
  ``test_torch_most_columns_implicit.py``); TR-BDF2 on the heat-only branch
  raises as not queued, beside JAX's own ``KeyError``.

The kernels are held against this plain version on the card in
``chip_smoke.py`` phase 20 and by the ``cuda``-marked test here, which skips
without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import imex as jimex
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.convert import stepper_from_reference
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_b4_most_policies import icy
from tests.test_torch_columns_rk import base_case, moving_bar_check, with_jax_columns
from tests.test_torch_land_policies_b5 import assert_matches, cuda_device  # noqa: F401

STEPPERS = {"trbdf2": "TRBDF2Soil", "be-soil": "BackwardEulerSoil", "be-richards": "BackwardEulerRichards"}
#: the implicit cases' steps
STEPS = 2
#: the step of the freeze column and of golden #1's
FREEZE_DT, GOLDEN_DT = 60.0, 120.0


def implicit_case(name):
    """``(JAX model, start state, stepper class name, tridiag, dt, t0)`` of
    a case named as the port names its run (``B4-be-soil+kinds+B8``,
    ``B4-trbdf2-water-no-ice+B2+kinds+B8``, ``B4-trbdf2-pcr+kinds+B8``): the
    stepper and branch from the name, its policies on the column
    ``base_case`` gives the explicit mode of the same policies."""
    mode = name.replace("+kinds", "").replace("+B8", "")
    key = next(k for k in STEPPERS if mode.startswith(f"B4-{k}"))
    rest = mode[len(f"B4-{key}"):]
    tridiag = "pcr" if "-pcr" in rest else "thomas"
    rest = rest.replace("-pcr", "")
    lagged = "+B2" in rest
    branch = "-water" if rest.startswith("-water") else ""
    no_ice = "-no-ice" in rest
    freeze = "+B3-rate" if "+B3-rate" in rest else "+B3-eq" if "+B3-eq" in rest else ""
    explicit = ("B2" if lagged else "B1") + branch + ("-no-ice" if no_ice else "") + freeze
    jm, Y, (_, _, t0) = base_case(explicit.replace("B1+", ""))
    jm = with_jax_columns(jm, depth=name.endswith("+B8"))
    return jm, Y, STEPPERS[key], tridiag, FREEZE_DT if freeze else GOLDEN_DT, t0


def jax_stepper(jm, stepper, tridiag):
    return getattr(jimex, stepper)(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2, tridiag=tridiag)


@functools.lru_cache(maxsize=None)
def jax_kernel(name):
    """JAX's fused kernel of a case in interpret mode over one tile, under
    ``jax.jit``: compiled once per process."""
    jm, _, stepper, tridiag, dt, _ = implicit_case(name)
    ncol = jm.domain.batch_shape[0]
    return jax.jit(jax_fused(jm, jax_stepper(jm, stepper, tridiag), dt=dt, steps_per_call=STEPS, tile_cols=ncol,
                             interpret=True))


def check_implicit(name, source, Y=None):
    """JAX's fused kernel against the port's fused run (its plain version on
    the CPU) on case ``name``: the run's name and source, the bar of
    ``assert_matches`` (PCR too: the two packages' PCR solves agree to a few
    ulps), the moving fields; returns ``(JAX model, start state, JAX final
    state)``."""
    jm, Y0, stepper, tridiag, dt, t0 = implicit_case(name)
    Y = Y0 if Y is None else Y(jm, Y0)
    ref = jax.tree_util.tree_map(np.asarray, jax_kernel(name)(Y, t0))
    model = model_from_reference(jm, device="cpu")
    st = stepper_from_reference(jax_stepper(jm, stepper, tridiag), model, device="cpu")
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=STEPS)
    assert run.name == name and ck._entry(run.mode, torch.float64)[0] == source
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, t0) is Yt and ck.LAUNCHES == before
    assert_matches(state_to_numpy(Yt), ref, jm)
    moving_bar_check(ref, Y, jm)
    return jm, Y, ref


IMPLICIT_CASES = (
    ("B4-be-soil+kinds+B8", "implicit_columns_kernel"),
    ("B4-be-richards+B2+B3-eq+kinds+B8", "implicit_columns_kernel"),
    ("B4-trbdf2-water-no-ice+B2+kinds+B8", "implicit_columns_kernel"),
    ("B4-trbdf2-pcr+kinds+B8", "implicit_kernel"),
)


@pytest.mark.parametrize("name,source", IMPLICIT_CASES, ids=[c[0] for c in IMPLICIT_CASES])
def test_implicit_columns_match_jax_fused(name, source):
    """BackwardEulerSoil without a policy, BackwardEulerRichards lagged with
    the equilibrium projection, TR-BDF2 on the water-only branch lagged
    without ice, and TR-BDF2 with PCR solves (``implicit_kernel.cu``'s
    instance, PCR at run time), each with per-column kinds and depths."""
    check_implicit(name, source)


def test_rate_freeze_thaw_under_trbdf2_freezes_and_melts():
    """``B4-trbdf2+B3-rate+kinds+B8`` on the cold column: ice grows in some
    cells and melts in others."""
    _, Y, ref = check_implicit("B4-trbdf2+B3-rate+kinds+B8", "implicit_columns_kernel")
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    assert int((change > 1e-8).sum()) > 10 and int((change < -1e-8).sum()) > 10


def test_no_ice_on_an_icy_state_with_kinds():
    """``B4-be-soil-no-ice+kinds`` on golden #1's column made icy, where the
    rhs caps theta_l at nu - theta_i and the sweeps keep the state's ice."""
    jm, Y, _ = check_implicit("B4-be-soil-no-ice+kinds", "implicit_columns_kernel", Y=icy)
    soil = {k: np.asarray(v) for k, v in Y["soil"].items()}
    assert np.any(soil["vartheta_l"] > np.asarray(jm.soil_param_set.nu) - soil["theta_i"])


# ---- every implicit mode on the plain soil, without JAX ----

#: the policy suffixes of POLICY_CASES (implicit_column.cuh) and of the water branch's WATER_POLICY_CASES
POLICIES = ("", "+B2", "+B3-rate", "+B3-eq", "-no-ice", "+B2+B3-rate", "+B2+B3-eq", "-no-ice+B2")
WATER_POLICIES = ("", "+B2", "-no-ice", "-no-ice+B2")


def plain_soil_names():
    """Every implicit plain-soil mode with per-column kinds and depths, as
    the port names its run: each stepper with each policy on the coupled
    branch, TR-BDF2 and BackwardEulerRichards with each water-branch policy,
    and TR-BDF2 with PCR."""
    names = [f"B4-{st}{p}+kinds+B8" for st in STEPPERS for p in POLICIES]
    names += [f"B4-{st}-water{p}+kinds+B8" for st in ("trbdf2", "be-richards") for p in WATER_POLICIES]
    return names + ["B4-trbdf2-pcr+kinds+B8", "B4-trbdf2-water-pcr+B2+kinds+B8"]


def test_every_implicit_plain_soil_mode_takes_kinds_and_geometry():
    """Each implicit mode on the plain soil (the 32 instances with
    ``MODE_COLUMNS``, PCR read at run time) builds a run with kinds and
    depths from the source that holds its instance: TR-BDF2 and
    BackwardEulerRichards without a policy from ``implicit_kernel``, the
    others from ``implicit_columns_kernel``."""
    instances = set()
    for name in plain_soil_names():
        jm, _, stepper, tridiag, dt, _ = implicit_case(name)
        model = model_from_reference(jm, device="cpu")
        st = stepper_from_reference(jax_stepper(jm, stepper, tridiag), model, device="cpu")
        run = ck.make_fused_column_run(model, st, dt=dt)
        assert run.name == name and ck.takes_per_column(run.mode)
        bare = name.replace("-pcr", "").replace("+kinds+B8", "")
        expected = "implicit_kernel" if bare in ("B4-trbdf2", "B4-be-richards", "B4-trbdf2-water",
                                                 "B4-be-richards-water") else "implicit_columns_kernel"
        assert ck._entry(run.mode, torch.float32)[0] == expected, name
        instances.add((expected, run.mode & ~ck.MODE_PCR))
    assert sum(1 for src, _ in instances if src == "implicit_columns_kernel") == 28
    assert sum(1 for src, _ in instances if src == "implicit_kernel") == 4


@pytest.mark.parametrize("stepper", sorted(STEPPERS.values()))
def test_most_implicit_modes_still_refuse_kinds_and_geometry(stepper):
    """Under a MOST top each implicit stepper, with a policy or without, now
    takes per-column kinds and geometry (queue B item 2's remainder, no
    longer refused): its run is named ``...+B5+kinds`` or ``...+B5+B8`` and
    launches ``implicit_most_columns_kernel``'s instance."""
    import chip_smoke as cs

    for policy in ("B5", "B5+B3-rate"):
        soil = cs.policy_variant(policy, torch.float64, "cpu")[0]
        for what, suffix in (("kinds", "+kinds"), ("depth", "+B8")):
            variant = cs.with_columns(soil, 3, kinds=what == "kinds", depth=what == "depth")
            run = ck.make_fused_column_run(variant, cs.implicit(stepper, variant, 2))
            assert re.fullmatch(rf"B4-\S*\+B5{re.escape(suffix)}", run.name), run.name
            assert ck.takes_per_column(run.mode) and ck._entry(run.mode, torch.float64)[0] == \
                "implicit_most_columns_kernel"


def test_heat_only_trbdf2_with_kinds_raises_in_both_packages():
    """TR-BDF2 on the heat-only branch with per-column energy kinds: JAX's
    fused kernel raises ``KeyError: 'theta_i'`` (its heat sweep reads
    theta_i from a state that holds none), and the port refuses it as not
    queued (``B4-trbdf2-heat`` without kinds is a deviation by decision,
    ROADMAP C)."""
    jm, Y, _ = base_case("B1-heat")
    jm = with_jax_columns(jm, depth=False)
    with pytest.raises(KeyError, match="theta_i"):
        jax_fused(jm, jax_stepper(jm, "TRBDF2Soil", "thomas"), dt=60.0, steps_per_call=1, tile_cols=8,
                  interpret=True)(Y, 0.0)
    model = model_from_reference(jm, device="cpu")
    st = stepper_from_reference(jax_stepper(jm, "TRBDF2Soil", "thomas"), model, device="cpu")
    with pytest.raises(NotImplementedError, match=r"B4-trbdf2-heat .*ROADMAP B1-batched, not queued\)"):
        ck.make_fused_column_run(model, st)
    bare = model_from_reference(base_case("B1-heat")[0], device="cpu")
    assert ck.make_fused_column_run(bare, stepper_from_reference(
        jax_stepper(base_case("B1-heat")[0], "TRBDF2Soil", "thomas"), bare, device="cpu")).name == "B4-trbdf2-heat"


def test_implicit_columns_source_instantiates_its_modes():
    """``implicit_columns_kernel.cu``: BackwardEulerSoil, ``POLICY_CASES``
    on the three steppers and ``WATER_POLICY_CASES`` on two, each with
    ``MODE_COLUMNS``; the policy instances without it moved to
    ``implicit_policy_kernel.cu``."""
    src = (ck.CSRC / "implicit_columns_kernel.cu").read_text()
    for st in ("MODE_TRBDF2", "MODE_BE_RICHARDS", "MODE_BE_SOIL"):
        assert f"POLICY_CASES({st} | MODE_COLUMNS)" in src
        assert f"POLICY_CASES({st})" in (ck.CSRC / "implicit_policy_kernel.cu").read_text()
        assert f"POLICY_CASES({st})" not in (ck.CSRC / "implicit_kernel.cu").read_text()
    for st in ("MODE_TRBDF2", "MODE_BE_RICHARDS"):
        assert f"WATER_POLICY_CASES({st} | MODE_COLUMNS)" in src
    assert "case MODE_BE_SOIL | MODE_COLUMNS:" in src


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B4-be-soil+kinds+B8", "B4-trbdf2+B3-rate+kinds+B8",
                                  "B4-trbdf2-water-no-ice+B2+kinds+B8", "B4-be-richards-no-ice+B2+kinds"])
def test_cuda_implicit_columns_instances_match_plain(cuda_device, name):  # noqa: F811
    """A launch of ``implicit_columns_kernel.cu``'s instances against the
    plain version on the card, f64 at rtol 1e-12."""
    jm, Y0, stepper, tridiag, dt, t0 = implicit_case(name)
    model = model_from_reference(jm, device=cuda_device)
    st = stepper_from_reference(jax_stepper(jm, stepper, tridiag), model, device=cuda_device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, dt, STEPS, state_from_numpy(Y0, device=cuda_device),
                                                     t0))
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=STEPS)
    Y = state_from_numpy(Y0, device=cuda_device)
    before = ck.LAUNCHES[run.name]
    run(Y, t0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1 and ck._entry(run.mode, torch.float64)[0] == "implicit_columns_kernel"
    assert_matches(state_to_numpy(Y), plain, jm)
