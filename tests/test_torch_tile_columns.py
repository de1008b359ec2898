"""The column-tile kernel (``csrc/tile_columns_kernel.cu``, body
``csrc/tile_column.cuh``): the coupled plain soil with stage coefficients and
per-column BC kinds and geometry, with ice (``B1+kinds+B8``) and under
``assume_no_ice`` (``B1-no-ice+kinds+B8``), under ForwardEuler, SSPRK22,
SSPRK33 and SSPRK104.

- Routing: ``_entry`` sends exactly these two modes, under each explicit
  stepper, to ``tile_columns_kernel``, and every other mode word where the
  routing before the tile kernel sent it (``parent_entry``, that routing
  kept here); the tile modes need no scratch.
- The host's tile plan (:func:`ck.tile_plan`, a pure function) fits a
  block: at most 1,024 threads (and the kernel's 256) and 232,448 B of
  dynamic shared memory, in both float types, for the depths of the runs
  and the checks, with a grid that covers phase 12's and 20a's widths; the
  host's mirror of the layout matches the header's constants.
- Each mode under each stepper on a column of nz=7 and 13 columns (a
  ragged tile: no plan puts 13 columns in a block), an icy start (0.05 of
  ice under vartheta_l = nu - 0.02 in the lower half, where the no-ice
  rhs caps theta_l at nu - theta_i), per-column kinds at both faces and
  depths: the port's fused run (its plain version on the CPU) against the
  JAX package's fused kernel in interpret mode, f64 at rtol 1e-12.
- On the card (``cuda``-marked, skipped without a GPU): the kernel against
  the plain version at odd and deep columns with ragged tiles.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import functools
import itertools
import re
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch

from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch import timestepping as pts
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.data import golden_config as gc
from tests.test_torch_b4_most_policies import icy
from tests.test_torch_columns_rk import moving_bar_check, with_jax_columns
from tests.test_torch_land_policies_b5 import assert_matches, cuda_device  # noqa: F401

STEPPERS = ("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104")
MODES = ("B1", "B1-no-ice")
#: the small case: golden #1's soil on NZ levels and NCOL columns, (dt, steps, t0) of its launch
NZ, NCOL, STEPS = 7, 13, (10.0, 3, 30.0)
#: the depths of the plan's check: the small case's, 16 (the 1,000-column checks), 24 (the forced and flagship
#: soils), 48 (phase 12, 20a), 64 (the benchmark configuration) and 150 (the verify recipe's column)
PLAN_NZ = (7, 16, 24, 48, 64, 150)
#: the widths of phase 12's and 20a's regional hour and of 20d's timings
PLAN_NCOL = (131072, 32768)


# ---- routing ----

#: the SSPRK33 MODE_COLUMNS instances with fixed stages before the tile kernel: B1 joined them
PARENT_SSPRK33_COLUMNS = ck._SSPRK33_COLUMNS | {ck.MODE_COLUMNS}


def parent_entry(mode):
    """The source ``_entry`` chose for ``mode`` before the tile kernel."""
    table_columns = mode & ck.MODE_COLUMNS and (mode & ck.MODE_RK or mode not in PARENT_SSPRK33_COLUMNS)
    if mode & ck.MODE_IMPLICIT:
        policy = mode & ck._POLICY_BITS
        if mode & ck.MODE_COLUMNS and mode & ck.MODE_MOST:
            return "implicit_most_columns_kernel"
        if mode & ck.MODE_COLUMNS and (policy or mode & ck.MODE_BE_SOIL):
            return "implicit_columns_kernel"
        if policy:
            return ("implicit_branch_kernel" if mode & ck.MODE_WATER
                    else "implicit_most_kernel" if mode & ck.MODE_MOST else "implicit_policy_kernel")
        return "implicit_kernel"
    if mode & (ck.MODE_MOST | ck.MODE_LAND):
        name = "land_policy" if mode & ck._FREEZE_OR_NO_ICE else "land"
        if table_columns:
            return name + "_columns_kernel"
        return name + ("_rk_kernel" if mode & ck.MODE_RK else "_kernel")
    if table_columns:
        return "rk_columns_kernel"
    if mode & ck.MODE_RK or (mode & (ck.MODE_WATER | ck.MODE_HEAT) and mode & (ck.MODE_LAGGED | ck.MODE_NO_ICE)):
        return "rk_kernel"
    return "column_kernel"


#: the step-policy bits of the mode word
POLICY_BITS = (ck.MODE_LAGGED, ck.MODE_FREEZE_RATE, ck.MODE_FREEZE_EQ, ck.MODE_NO_ICE)


def mode_words():
    """Every mode word of the bits ``_entry`` reads: the policies, the branch, the surface, MODE_COLUMNS, the
    stepper (SSPRK33 without a bit) and PCR."""
    policies = [sum(c) for n in range(5) for c in itertools.combinations(POLICY_BITS, n)]
    branches = (0, ck.MODE_WATER, ck.MODE_HEAT)
    surfaces = (0, ck.MODE_MOST, ck.MODE_LAND, ck.MODE_LAND | ck.MODE_MOST,
                ck.MODE_LAND | ck.MODE_SURFACE_STEP, ck.MODE_LAND | ck.MODE_MOST | ck.MODE_SURFACE_STEP)
    steppers = (0, ck.MODE_EULER, ck.MODE_SSPRK22, ck.MODE_SSPRK104, ck.MODE_TRBDF2, ck.MODE_BE_SOIL,
                ck.MODE_BE_RICHARDS, ck.MODE_TRBDF2 | ck.MODE_PCR)
    for p, b, s, c, st in itertools.product(policies, branches, surfaces, (0, ck.MODE_COLUMNS), steppers):
        yield p | b | s | c | st


def test_entry_sends_the_two_modes_to_the_tile_kernel():
    """``B1+kinds+B8`` and ``B1-no-ice+kinds+B8`` under each explicit stepper
    launch from ``tile_columns_kernel`` in both float types, and every other
    mode word from the source it launched from before."""
    tile = set()
    for mode in mode_words():
        for dtype in (torch.float32, torch.float64):
            name, fn = ck._entry(mode, dtype)
            if name == "tile_columns_kernel":
                tile.add(mode)
                assert fn == "tile_columns_kernel_" + ("f32" if dtype == torch.float32 else "f64")
            else:
                assert name == parent_entry(mode), (ck.mode_name(mode), name)
    assert tile == {m | st for m in (ck.MODE_COLUMNS, ck.MODE_NO_ICE | ck.MODE_COLUMNS)
                    for st in (0, ck.MODE_EULER, ck.MODE_SSPRK22, ck.MODE_SSPRK104)}
    assert ck.TILE_MODES == {ck.MODE_COLUMNS, ck.MODE_NO_ICE | ck.MODE_COLUMNS}
    assert "tile_columns_kernel" in ck.SOURCES and ck.SOURCES["tile_columns_kernel"].exists()


@pytest.mark.parametrize("mode", sorted(ck.TILE_MODES))
def test_tile_modes_need_no_scratch(mode):
    """The tile kernel keeps its stage registers in shared memory: no scratch
    under any explicit stepper; the stage-table twins without MODE_COLUMNS
    keep their six fields."""
    for st in (0, ck.MODE_EULER, ck.MODE_SSPRK22, ck.MODE_SSPRK104):
        assert ck.scratch_fields(mode | st) == 0
        assert ck.scratch_fields((mode & ~ck.MODE_COLUMNS) | st) == 6


# ---- the tile plan ----


@pytest.mark.parametrize("itemsize", (4, 8))
@pytest.mark.parametrize("nz", PLAN_NZ)
def test_tile_plan_fits_a_block(itemsize, nz):
    """For each stepper's registers and each ``tile_cols`` a run may take:
    at most 1,024 threads (the kernel's 256) and 232,448 B of dynamic shared
    memory a block, at most ``tile_cols`` columns, the bytes of the layout,
    lanes a power of two below 2 nz, at least one block an SM within its
    shared memory, and a grid that covers phase 12's and 20a's widths in
    fewer than 2^31 blocks; the default plan keeps as many threads an SM
    busy as the launch bounds allow (f64 two blocks of 256, f32 three)."""
    for n_regs in (1, 2, 3):
        for tile_cols in (32, 64, 128, 256, 512, 1024):
            plan = ck.tile_plan(nz, itemsize, n_regs, tile_cols)
            assert plan.columns * plan.lanes <= ck.TILE_MAX_THREADS <= 1024 and plan.columns <= tile_cols
            assert plan.smem_bytes == ck.tile_smem_bytes(nz, plan.columns, n_regs, itemsize) <= 232448
            assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes < 2 * nz
            assert plan.blocks_per_sm >= 1
            assert plan.blocks_per_sm * (plan.smem_bytes + ck.SM_SMEM_PER_BLOCK) <= ck.SM_SMEM
            for ncol in PLAN_NCOL:
                assert -(-ncol // plan.columns) < 2 ** 31
    plan = ck.tile_plan(nz, itemsize, 3)
    assert plan.blocks_per_sm * plan.columns * plan.lanes == ck.TILE_MIN_BLOCKS[itemsize] * ck.TILE_MAX_THREADS


def test_tile_plan_refuses_a_column_past_a_block():
    """A column whose cells do not fit one block's shared memory raises, naming its bytes."""
    with pytest.raises(ValueError, match="past a block's 232448 B"):
        ck.tile_plan(1800, 8, 3)
    assert ck.tile_plan(1700, 8, 3).columns == 1


def test_tile_layout_mirrors_the_header():
    """The host's constants are the header's: the block's threads and launch
    bounds, the shared-memory limit, the planes per cell and
    ``sizeof(Column<T>)`` as the source asserts it."""
    header = (ck.CSRC / "tile_column.cuh").read_text()
    source = (ck.CSRC / "tile_columns_kernel.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kTile\w+) = (\d+);", header))
    assert int(consts["kTileMaxThreads"]) == ck.TILE_MAX_THREADS
    assert int(consts["kTileMaxSmem"]) == ck.TILE_MAX_SMEM
    f64, f32 = re.search(r"value = sizeof\(T\) == 8 \? (\d+) : (\d+);", header).groups()
    assert (int(f64), int(f32)) == (ck.TILE_MIN_BLOCKS[8], ck.TILE_MIN_BLOCKS[4])
    for itemsize, regs in ck.TILE_REGISTERS.items():
        assert ck.TILE_MAX_THREADS * ck.TILE_MIN_BLOCKS[itemsize] * regs <= ck.SM_REGISTERS
    planes = re.search(r"enum TilePlane \{([^}]*)\}", header).group(1).split(",")
    assert len(planes) - 1 == ck.TILE_PLANES  # the last entry counts them
    sizes = re.search(r"sizeof\(Column<double>\) == (\d+) && sizeof\(Column<float>\) == (\d+)", source)
    assert (int(sizes.group(1)), int(sizes.group(2))) == (ck.TILE_COLUMN_BYTES[8], ck.TILE_COLUMN_BYTES[4])
    assert ck.stage_registers(ck.stage_table(pts.ForwardEuler(), 1.0, torch.float64)) == 1
    assert ck.stage_registers(ck.stage_table(pts.SSPRK22(), 1.0, torch.float64)) == 2
    assert ck.stage_registers(ck.stage_table(pts.SSPRK33(), 1.0, torch.float64)) == 3
    assert ck.stage_registers(ck.stage_table(pts.SSPRK104(), 1.0, torch.float64)) == 3


def test_registers_and_records_name_the_tile_instances(tmp_path):
    """``chip_smoke.py``'s ptxas parser names the tile kernel's instances
    ``tile:<mode>`` (the no-ice one without its MODE_RHS_CAP bit), and
    ``kernel_of`` its kernel and source for the kernels line; ``--compare-with``
    skips the register check of the three instances it replaced, times both
    modes, and builds it in phase 2, ahead of phase 12."""
    import chip_smoke as cs

    no_ice = ck.MODE_COLUMNS | ck.MODE_NO_ICE | ck.MODE_RHS_CAP
    report = {"tile_columns_kernel": "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118tile_column_kernelI{t}Li{m}EEEv10KernelArgs"
        f"{t}{t}i' for 'sm_90a'\nptxas info    : Used {r} registers\n"
        for t, m, r in (("d", ck.MODE_COLUMNS, 128), ("f", no_ice, 96)))}
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report.get(name, ""))
    assert cs.registers(ck, libs) == {"f64, tile:B1+kinds+B8": 128, "f32, tile:B1-no-ice+kinds+B8": 96}
    for mode in (ck.MODE_COLUMNS, ck.MODE_COLUMNS | ck.MODE_NO_ICE | ck.MODE_SSPRK104):
        assert cs.kernel_of(ck, mode, torch.float32) == (
            "tile_column_kernel", "landhydrology_tpu_torch/csrc/tile_columns_kernel.cu")
    assert cs.REDESIGNED == ("B1+kinds+B8", "rk:B1+kinds+B8", "rk:B1-no-ice+kinds+B8")
    assert set(cs.COMPARE_TILE) == {"B1+kinds", "B1+kinds+B8", "B1-no-ice+kinds", "B1-no-ice+kinds+B8"}
    assert "tile_columns_kernel" in cs.FIRST_SOURCES and "tile_columns_kernel" not in cs.LATER_ORDER


def test_compare_with_holds_the_redesigned_modes_to_the_parent(monkeypatch, capsys):
    """``--compare-with``: the three instances the tile kernel replaced drop
    out of the parent's registers without failing the check, and are printed
    beside the tile instances; a tile mode's time must be below the
    parent's, while the other instances keep their 2% bar."""
    import json
    import subprocess

    import chip_smoke as cs

    def run(cmd, cwd, tile_ms=60.0, **kwargs):
        parent = cwd == "parent"
        regs = {"f64, B1": 200, **({"f64, B1+kinds+B8": 255, "f64, rk:B1+kinds+B8": 255,
                                    "f64, rk:B1-no-ice+kinds+B8": 255} if parent
                                   else {"f64, tile:B1+kinds+B8": 128, "f64, tile:B1-no-ice+kinds+B8": 128})}
        ms = {"float64 B1": [40.0] * 4, "float64 B1-no-ice+kinds": [110.0 if parent else tile_ms] * 4}
        out = {"registers": regs, "spills": {"f64, B1+kinds+B8": 64} if parent else {}, "ms": ms}
        return subprocess.CompletedProcess(cmd, 0, "COMPARE " + json.dumps(out), "")

    monkeypatch.setattr(subprocess, "run", run)
    cs.compare_with("parent", "smi")
    out = capsys.readouterr().out
    assert "changed none" in out and "f64, B1+kinds+B8 255 registers / 64 B spill stores" in out
    assert "f64, tile:B1-no-ice+kinds+B8 128 / 0" in out
    assert "float64 B1-no-ice+kinds 48 steps per launch" in out and "median ratio 0.5455 (bar below 1" in out
    monkeypatch.setattr(subprocess, "run", lambda cmd, cwd, **kw: run(cmd, cwd, tile_ms=110.0))
    with pytest.raises(AssertionError, match="not faster than the parent's instance: float64 B1-no-ice"):
        cs.compare_with("parent", "smi")


# ---- against the JAX package's kernel ----


def small_case(mode):
    """``(JAX model, start state)``: golden #1's soil on NZ levels and NCOL
    columns with per-column kinds at both faces and depths
    (``with_jax_columns``), ``assume_no_ice`` for ``B1-no-ice``, from the icy
    start."""
    with mock.patch.object(gc, "NZ", NZ), mock.patch.object(gc, "NCOL", NCOL):
        jm, Y, _, _ = gc.build_model_and_state(jnp.float64)
    jm = with_jax_columns(jm, depth=True)
    if mode == "B1-no-ice":
        jm = dataclasses.replace(jm, assume_no_ice=True)
    return jm, icy(jm, Y)


@functools.lru_cache(maxsize=None)
def jax_kernel(mode, stepper):
    """JAX's fused kernel of a small case in interpret mode over one tile,
    under ``jax.jit``."""
    jm, _ = small_case(mode)
    dt, n, _ = STEPS
    return jax.jit(jax_fused(jm, getattr(jts, stepper)(), dt=dt, steps_per_call=n, tile_cols=NCOL, interpret=True))


@pytest.mark.parametrize("stepper", STEPPERS)
@pytest.mark.parametrize("mode", MODES)
def test_tile_modes_match_jax_fused(mode, stepper):
    """Each mode under each stepper: the port's run is named for its mode,
    launches from the tile kernel on the card, and on the CPU (its plain
    version, no launch) matches JAX's kernel at rtol 1e-12; every field the
    case moves changes by more than its bar."""
    jm, Y = small_case(mode)
    dt, n, t0 = STEPS
    ref = jax.tree_util.tree_map(lambda v: jnp.asarray(v).__array__(), jax_kernel(mode, stepper)(Y, t0))
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, getattr(pts, stepper)(), dt=dt, steps_per_call=n)
    assert run.name == mode + "+kinds+B8" + ("" if stepper == "SSPRK33" else "@" + stepper)
    assert ck._entry(run.mode, torch.float64)[0] == "tile_columns_kernel"
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, t0) is Yt and ck.LAUNCHES == before
    assert_matches(state_to_numpy(Yt), ref, jm)
    moving_bar_check(ref, Y, jm)


# ---- on the card ----

#: (nz, ncol) of the card's checks: the small case's depth and the verify recipe's, each with a ragged tile
CUDA_SHAPES = ((7, 1001), (150, 333))


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", ("SSPRK33", "SSPRK104"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_tile_kernel_matches_plain(cuda_device, shape, mode, stepper):  # noqa: F811
    """A launch of the tile kernel against the plain version on the card, f64
    at rtol 1e-12 and f32 within 1e-5 of each field's scale, one launch
    counted under the run's name."""
    nz, ncol = shape
    with mock.patch.object(gc, "NZ", nz), mock.patch.object(gc, "NCOL", ncol):
        jm, Y0, _, _ = gc.build_model_and_state(jnp.float64)
    jm = with_jax_columns(jm, depth=True)
    if mode == "B1-no-ice":
        jm = dataclasses.replace(jm, assume_no_ice=True)
    Y0 = icy(jm, Y0)
    dt, n, t0 = STEPS
    for dtype in (torch.float64, torch.float32):
        model = model_from_reference(jm, device=cuda_device, dtype=dtype)
        st = getattr(pts, stepper)()
        plain = state_to_numpy(ck.fused_column_run_plain(
            model, st, dt, n, state_from_numpy(Y0, device=cuda_device, dtype=dtype), t0))
        run = ck.make_fused_column_run(model, st, dt=dt, steps_per_call=n)
        Y = state_from_numpy(Y0, device=cuda_device, dtype=dtype)
        before = ck.LAUNCHES[run.name]
        run(Y, t0)
        torch.cuda.synchronize()
        assert ck.LAUNCHES[run.name] == before + 1 and ck._entry(run.mode, dtype)[0] == "tile_columns_kernel"
        got = state_to_numpy(Y)
        if dtype == torch.float64:
            assert_matches({"soil": got["soil"]}, {"soil": plain["soil"]}, jm)
        else:
            for k, v in plain["soil"].items():
                scale = float(abs(v).max()) or 1.0
                assert float(abs(got["soil"][k] - v).max()) <= 1e-5 * scale, k
