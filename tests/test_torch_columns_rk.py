"""Per-column BC kinds and geometry in the plain-soil modes under the
explicit steppers (kernel modes B1-batched and B8 with ``MODE_COLUMNS``:
``csrc/rk_columns_kernel.cu`` under ForwardEuler, SSPRK22, SSPRK33 and
SSPRK104 from the stage table, ``csrc/column_kernel.cu``'s fixed-stage
SSPRK33 B2, B3-rate and B1-water, and the column-tile kernel of
``csrc/tile_columns_kernel.cu`` for B1 and B1-no-ice under every stepper)
through the kernel's plain version, against the JAX package's fused kernel
in interpret mode.

- The columns: golden #1's soil (nz=24 x 8, a callable Dirichlet top for
  the water, per-column soils), or the freeze golden's soil widened to
  ``FREEZE_NCOL`` columns at 268-278 K by column with 0.02 of ice (the
  freeze cases), each with a ``BatchedBC`` hydrology bottom (FLUX,
  DIRICHLET and FREE_DRAINAGE by column) and a ``BatchedBC`` energy top
  (FLUX or DIRICHLET by column), on a ``VariableDepthColumn`` (0.8-1.2 of
  the column's depth) where the name carries ``+B8``; the water-only branch
  with the temperature prescribed, the heat-only one with the moisture
  (``test_torch_rk_branches.py``'s profiles).
- f64 at rtol 1e-12 (atol 1e-16; ``assert_matches``' ulp allowance in the
  equilibrium case), one tile, JAX's kernel compiled once per case
  (``jax.jit``).  Every field the case moves changes by more than its bar.
- A check of every plain-soil mode under every explicit stepper without
  JAX: each takes kinds, geometry and both, names its instance and source.

The implicit steppers' cases are in ``test_torch_columns_implicit.py``.  The
kernels are held against this plain version on the card in
``chip_smoke.py`` phase 20 and by the ``cuda``-marked test here, which
skips without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import BatchedBC as JBatchedBC
from landhydrology_tpu import SoilColumnBC as JSoilColumnBC
from landhydrology_tpu import VariableDepthColumn as JVariableDepth
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.constants import default_earth_param_set as jps
from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq
from landhydrology_tpu.models.soil.freeze_thaw import FreezeThaw as JRate
from landhydrology_tpu.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch import timestepping as pts
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.data import golden_config as gc
from tests.test_torch_b4_most_policies import icy
from tests.test_torch_land_policies_b5 import assert_matches, cuda_device  # noqa: F401
from tests.test_torch_rk_branches import branch_case

#: the freeze cases' columns; the steps (dt, steps, t0) of the golden and the freeze columns
FREEZE_NCOL = 12
GOLDEN_STEPS, FREEZE_STEPS = (10.0, 3, 30.0), (5.0, 4, 0.0)
#: the options of the policies in a mode name
OPTIONS = {"B2": {"coefficient_update": "step"}, "no-ice": {"assume_no_ice": True},
           "B3-rate": {"freeze_thaw": JRate(tau=60.0)}, "B3-eq": {"freeze_thaw": JEq()}}


def freeze_column():
    """The freeze golden's soil on ``FREEZE_NCOL`` columns, without its own
    freeze-thaw, and a start state at 268-278 K by column (water 0.20-0.30,
    0.02 of ice): ice forms in the cold columns and melts in the warm ones."""
    jm, _, _, _ = gc.build_freeze_model_and_state(jnp.float64)
    jm = dataclasses.replace(jm, freeze_thaw=None, domain=dataclasses.replace(jm.domain, batch_shape=(FREEZE_NCOL,)))
    nz = jm.domain.nelements
    col = np.linspace(0.0, 1.0, FREEZE_NCOL)[None]
    theta = np.broadcast_to(0.20 + 0.1 * col, (nz, FREEZE_NCOL))
    ice = np.full((nz, FREEZE_NCOL), 0.02)
    T = np.broadcast_to(268.0 + 10.0 * col, (nz, FREEZE_NCOL))
    rho_c_s = volumetric_heat_capacity(theta, ice, jm.soil_param_set.rho_c_ds, jps)
    Y = {"soil": {"vartheta_l": jnp.asarray(theta), "theta_i": jnp.asarray(ice),
                  "rho_e_int": jnp.asarray(volumetric_internal_energy(ice, rho_c_s, T, jps))}}
    return jm, Y


def with_jax_columns(jm, depth=True, seed=5):
    """``jm`` with a ``BatchedBC`` hydrology bottom (FLUX -1e-7 m/s,
    DIRICHLET 0.30 or FREE_DRAINAGE by column) where the hydrology is
    dynamic, a ``BatchedBC`` energy top (FLUX 0 or DIRICHLET 268-291 K by
    column) where the energy is, and with ``depth`` a ``VariableDepthColumn``
    of 0.8-1.2 times its depth."""
    from landhydrology_tpu import SoilEnergyModel, SoilHydrologyModel

    rng = np.random.default_rng(seed)
    ncol, nz = jm.domain.batch_shape[0], jm.domain.nelements
    bcs = jm.boundary_conditions
    top, bottom = bcs.top, bcs.bottom
    if isinstance(jm.hydrology_model, SoilHydrologyModel):
        kind = jnp.asarray(np.arange(ncol) % 3, dtype=jnp.int32)
        bottom = dataclasses.replace(bottom, hydrology=JBatchedBC(kind=kind, value=jnp.where(kind == 1, 0.30, -1e-7)))
    if isinstance(jm.energy_model, SoilEnergyModel):
        kind = jnp.asarray((np.arange(ncol) // 2) % 2, dtype=jnp.int32)
        value = jnp.where(kind == 1, jnp.asarray(rng.uniform(268.0, 291.0, ncol)), 0.0)
        top = dataclasses.replace(top, energy=JBatchedBC(kind=kind, value=value))
    jm = dataclasses.replace(jm, boundary_conditions=JSoilColumnBC(top=top, bottom=bottom))
    if depth:
        z_bottom, z_top = jm.domain.zlim
        jm = dataclasses.replace(jm, domain=JVariableDepth(
            z_bottom=jnp.asarray(z_top - (z_top - z_bottom) * rng.uniform(0.8, 1.2, ncol)), z_top=z_top,
            nelements=nz, batch_shape=(ncol,)))
    return jm


def base_case(mode):
    """``(JAX model with its options, start state, (dt, steps, t0))`` of a
    plain-soil mode name without its stepper and per-column suffixes
    (``B2-no-ice``, ``B2+B3-eq``, ``B2-water``, ``B1-heat-no-ice``, ...): the
    branch columns of ``test_torch_rk_branches.py``, the freeze column for
    the freeze-thaw modes, else golden #1's."""
    options = dict(OPTIONS["B2"]) if mode.startswith("B2") else {}
    for policy in ("no-ice", "B3-rate", "B3-eq"):
        if policy in mode:
            options.update(OPTIONS[policy])
    for branch in ("water", "heat"):
        if f"-{branch}" in mode:
            jm, Y, dt, n, t0 = branch_case(branch, "")
            return dataclasses.replace(jm, **options), Y, (dt, n, t0)
    if "B3" in mode:
        jm, Y = freeze_column()
        return dataclasses.replace(jm, **options), Y, FREEZE_STEPS
    jm, Y, _, _ = gc.build_model_and_state(jnp.float64)
    return dataclasses.replace(jm, **options), Y, GOLDEN_STEPS


def columns_case(name):
    """``(JAX model, start state, stepper name, dt, steps, t0)`` of a case
    named as the port names its run (``B1-no-ice+kinds+B8``,
    ``B2-water+kinds+B8@SSPRK22``, ...)."""
    mode, _, stepper = name.partition("@")
    base = mode.replace("+kinds", "").replace("+B8", "")
    jm, Y, (dt, n, t0) = base_case(base)
    jm = with_jax_columns(jm, depth=mode.endswith("+B8"))
    return jm, Y, stepper or "SSPRK33", dt, n, t0


@functools.lru_cache(maxsize=None)
def jax_kernel(name):
    """JAX's fused kernel of a case in interpret mode over one tile, under
    ``jax.jit``: compiled once per process."""
    jm, _, stepper, dt, n, _ = columns_case(name)
    ncol = jm.domain.batch_shape[0]
    return jax.jit(jax_fused(jm, getattr(jts, stepper)(), dt=dt, steps_per_call=n, tile_cols=ncol, interpret=True))


def moving_bar_check(ref, start, jm):
    """Every field the case moves (theta_i only under freeze-thaw) changes by
    more than a thousand times its bar (1e-12 of its scale, and 1e-16)."""
    soil = {k: np.asarray(v) for k, v in start["soil"].items()}
    for k, v in ref["soil"].items():
        if k == "theta_i" and jm.freeze_thaw is None:
            continue
        change = float(np.max(np.abs(v - soil[k])))
        assert change > 1e3 * (1e-12 * float(np.max(np.abs(soil[k]))) + 1e-16), (k, change)


def check_case(name, source, Y=None):
    """JAX's fused kernel against the port's fused run (its plain version on
    the CPU, no launch) on case ``name``: the run's name and source, the
    bar of ``assert_matches``, the moving fields; returns ``(JAX model, start
    state, JAX final state)``."""
    jm, Y0, stepper, dt, n, t0 = columns_case(name)
    Y = Y0 if Y is None else Y(jm, Y0)
    ref = jax.tree_util.tree_map(np.asarray, jax_kernel(name)(Y, t0))
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, getattr(pts, stepper)(), dt=dt, steps_per_call=n)
    assert run.name == name and ck._entry(run.mode, torch.float64)[0] == source
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, t0) is Yt and ck.LAUNCHES == before
    assert_matches(state_to_numpy(Yt), ref, jm)
    moving_bar_check(ref, Y, jm)
    return jm, Y, ref


def test_no_ice_cap_on_an_icy_state():
    """``B1-no-ice+kinds+B8`` (the stage table's SSPRK33) on golden #1's
    column made icy (vartheta_l = nu - 0.02 over 0.05 of ice in the lower
    half), where the rhs caps theta_l at nu - theta_i and the cap decides
    the closures."""
    jm, Y, _ = check_case("B1-no-ice+kinds+B8", "tile_columns_kernel", Y=icy)
    soil = {k: np.asarray(v) for k, v in Y["soil"].items()}
    assert np.any(soil["vartheta_l"] > np.asarray(jm.soil_param_set.nu) - soil["theta_i"])


def test_lagged_equilibrium_freezes_and_melts():
    """``B2+B3-eq+kinds+B8``: lagged coefficients and the equilibrium
    projection under SSPRK33 from the stage table on the cold column; ice
    grows in some cells and melts in others."""
    _, Y, ref = check_case("B2+B3-eq+kinds+B8", "rk_columns_kernel")
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    assert int((change > 1e-8).sum()) > 10 and int((change < -1e-8).sum()) > 10


def test_rate_freeze_thaw_geometry_on_fixed_stages():
    """``B3-rate+kinds+B8`` under SSPRK33: ``column_kernel.cu``'s fixed-stage
    ``MODE_COLUMNS`` instance, which already read the geometry, now with it
    opened."""
    _, Y, ref = check_case("B3-rate+kinds+B8", "column_kernel")
    change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
    assert int((change > 1e-8).sum()) > 10 and int((change < -1e-8).sum()) > 10


STEPPER_CASES = ("B1+kinds+B8@SSPRK104", "B2-no-ice+kinds+B8@ForwardEuler", "B2-water+kinds+B8@SSPRK22",
                 "B1-heat-no-ice+kinds+B8@SSPRK104")


@pytest.mark.parametrize("name", STEPPER_CASES)
def test_other_steppers_match_jax_fused(name):
    """One mode per family under each other explicit stepper: the coupled
    soil, lagged without ice, the water-only branch lagged, the heat-only
    branch without ice (its energy kinds at the top face, its profiles on
    each column's own centers); the coupled soil's instance is the
    column-tile kernel's."""
    check_case(name, source_of(name))


# ---- every plain-soil mode, without JAX ----

#: the plain-soil modes of rk_kernel.cu's dispatch (with the stepper, each also under SSPRK33)
RK_MODES = ("B1", "B2", "B1-no-ice", "B2-no-ice", "B3-rate", "B2+B3-rate", "B3-eq", "B2+B3-eq", "B1-water",
            "B2-water", "B1-water-no-ice", "B2-water-no-ice", "B1-heat", "B2-heat", "B1-heat-no-ice",
            "B2-heat-no-ice")
#: the SSPRK33 modes whose MODE_COLUMNS instance keeps column_kernel.cu's fixed stages
FIXED_STAGES = frozenset({"B2", "B3-rate", "B1-water"})
#: the modes whose MODE_COLUMNS instance is the column-tile kernel's, under every explicit stepper
TILE_STAGES = frozenset({"B1", "B1-no-ice"})


def source_of(name):
    """The source of a run named ``name`` (``B1-no-ice+kinds+B8``,
    ``B2+kinds+B8@SSPRK104``, ...)."""
    mode, _, stepper = name.partition("@")
    base = mode.replace("+kinds", "").replace("+B8", "")
    if base in TILE_STAGES:
        return "tile_columns_kernel"
    return "column_kernel" if not stepper and base in FIXED_STAGES else "rk_columns_kernel"


def port_columns_model(mode, kinds, depth):
    """The port model of ``mode`` (a name of ``RK_MODES``) with per-column
    kinds and / or depths (``with_jax_columns``)."""
    jm, _, _ = base_case(mode)
    jm = with_jax_columns(jm, depth=depth)
    if not kinds:
        jm = dataclasses.replace(jm, boundary_conditions=base_case(mode)[0].boundary_conditions)
    return model_from_reference(jm, device="cpu")


def test_every_plain_soil_mode_takes_kinds_and_geometry():
    """Each of the 16 plain-soil modes with per-column kinds, with per-column
    geometry and with both, under each explicit stepper: its name ends in
    ``+kinds`` / ``+B8`` and the stepper, it launches from
    ``rk_columns_kernel`` (SSPRK33 in B2, B3-rate and B1-water from
    ``column_kernel``'s fixed stages, B1 and B1-no-ice under every stepper
    from ``tile_columns_kernel``), one ``MODE_COLUMNS`` instance per
    mode."""
    names = set()
    for mode in RK_MODES:
        for kinds, depth in ((True, False), (False, True), (True, True)):
            model = port_columns_model(mode, kinds, depth)
            for stepper in ("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104"):
                run = ck.make_fused_column_run(model, getattr(pts, stepper)())
                suffix = ("+kinds" if kinds else "") + ("+B8" if depth else "")
                assert run.name == mode + suffix + ("" if stepper == "SSPRK33" else "@" + stepper)
                assert run.mode & ck.MODE_COLUMNS and ck.takes_per_column(run.mode)
                lib = ck._entry(run.mode, torch.float32)[0]
                assert lib == ("tile_columns_kernel" if mode in TILE_STAGES
                               else "column_kernel" if stepper == "SSPRK33" and mode in FIXED_STAGES
                               else "rk_columns_kernel")
                names.add(ck.mode_name(run.mode & ~ck.MODE_RK))
    assert len(names) == 16


def test_rk_columns_source_instantiates_the_sixteen_modes():
    """``rk_kernel.cu`` instantiates ``rk_column.cuh``'s ``RK_CASES``, all
    sixteen modes, and ``rk_columns_kernel.cu`` its ``RK_OTHER_CASES`` with
    ``MODE_COLUMNS``: the fourteen but the coupled soil with stage
    coefficients, with ice and without, whose ``MODE_COLUMNS`` instances are
    the column-tile kernel's (``tile_columns_kernel.cu``)."""
    src = (ck.CSRC / "rk_columns_kernel.cu").read_text()
    assert "RK_OTHER_CASES(MODE_COLUMNS)" in src and "RK_CASES(" not in src
    assert "RK_CASES(0)" in (ck.CSRC / "rk_kernel.cu").read_text()
    cases = (ck.CSRC / "rk_column.cuh").read_text()
    whole = cases[cases.index("#define RK_CASES"):cases.index("#define RK_OTHER_CASES")]
    other = cases[cases.index("#define RK_OTHER_CASES"):cases.index("#define RK_BRANCH_CASES")]
    branch = cases[cases.index("#define RK_BRANCH_CASES"):]
    # RK_CASES: the two coupled stage-coefficient modes and RK_OTHER_CASES; that one six coupled modes and four
    # per branch from RK_BRANCH_CASES, which it expands twice
    assert whole.count("case ") == 2 and "RK_OTHER_CASES(C)" in whole
    assert other.count("case ") == 6 and other.count("RK_BRANCH_CASES(MODE_") == 2
    assert branch.count("case ") == 4
    tile = (ck.CSRC / "tile_columns_kernel.cu").read_text()
    assert tile.count("case ") == 2 and "case MODE_COLUMNS:" in tile and "case MODE_NO_ICE | MODE_COLUMNS:" in tile


# ---- on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["B1-no-ice+kinds+B8", "B2+B3-eq+kinds+B8@SSPRK22", "B2-water+kinds+B8@SSPRK104",
                                  "B1-heat+kinds+B8@ForwardEuler"])
def test_cuda_rk_columns_instances_match_plain(cuda_device, name):  # noqa: F811
    """A launch of ``rk_columns_kernel.cu``'s instances (``B1-no-ice+kinds+B8``:
    the column-tile kernel's) against the plain version on the card, f64 at
    rtol 1e-12 (the equilibrium case within ``assert_matches``'
    allowance)."""
    jm, Y0, stepper, dt, n, t0 = columns_case(name)
    model = model_from_reference(jm, device=cuda_device)
    st = getattr(pts, stepper)()
    plain = {"soil": state_to_numpy(ck.fused_column_run_plain(
        model, st, dt, n, state_from_numpy(Y0, device=cuda_device), t0))["soil"]}
    run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)
    Y = state_from_numpy(Y0, device=cuda_device)
    before = ck.LAUNCHES[run.name]
    run(Y, t0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1 and ck._entry(run.mode, torch.float64)[0] == source_of(name)
    assert_matches({"soil": state_to_numpy(Y)["soil"]}, plain, jm)
