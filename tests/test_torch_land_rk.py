"""The explicit steppers ForwardEuler, SSPRK22 and SSPRK104 under a MOST top
and a LandModel (kernel modes B5 and B6 with the stage table of
``csrc/land_column.cuh``: ``B5@ForwardEuler``, ``B2+B6-step+B7@SSPRK104``,
...) through the kernel's plain version, against the JAX package's fused
kernel in interpret mode tracing the same stepper.

- The cases and the bar are ``test_torch_land_policies_b5.py``'s: the cold
  column (nz=16, 268-278 K, 0.02 of ice; ``CHECK_NCOL`` columns in one tile,
  the cases of ``FULL_CASES`` 256 in two tiles of 128, one per source)
  under a cold MOST atmosphere and the LandModel around it, 2 steps of 2 s
  from t0 = 30 s, JAX's kernel compiled once per case, f64 rtol
  1e-12 (the pond atol 1e-18), the equilibrium cases within the ulp
  allowance of its ``assert_matches`` in at most ``EQ_CELLS`` columns (not
  cells: the cold column's levels below the top share one state, so one
  flip of the projection repeats on a dozen levels of its column; under
  SSPRK104 theta_i of column 203, 9.1e-5, lands 2.4e-16 apart on 12
  levels, 1e-3 of the allowance); the no-ice cases on the icy state, where
  the rhs's cap of theta_l at nu - theta_i matters; the rows of
  ``test_torch_land_policies_rows.py`` (step-indexed, or time-indexed on its
  grid).
- Each flag of the land body under a new stepper: B5, B2+B5, B6, B6-step,
  B2+B6-step (also with rows under SSPRK104), rate and equilibrium
  freeze-thaw and no ice under MOST (here) and with a LandModel (here and
  in ``test_torch_land_rk_pond.py``, which holds the plain tops and the
  LandModel on a water-only soil); each stepper four times or more.
- The mode names and entries of the 48 land instances under each new
  stepper, the stage table a land launch carries, and the ``MODE_COLUMNS``
  land instances under the new steppers, and their implicit neighbours
  under the MOST top (``implicit_most_columns_kernel.cu``).

The kernel itself is held against this plain version on the card in
``chip_smoke.py`` phase 18c; the ``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from landhydrology_tpu import PrescribedAtmosForcing as JAtmos
from landhydrology_tpu import timestepping as jts
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch import timestepping as pts
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_pallas_kernel import NCOL, NZ
from tests.test_torch_land import _jax_land
from tests.test_torch_land_policies_b5 import (  # noqa: F401
    CHECK_NCOL, COLD_ATMOS, DT, EQ_CELLS, POLICIES, STEPS, T0, cold_state, cuda_device, soil_of, tile_of,
    ulp_allowance,
)
from tests.test_torch_land_policies_rows import TIME_GRID, forcing_rows
from tests.test_torch_land_water import jax_water_land, rain_rows, water_state

#: the new steppers of the land kernel
NEW_STEPPERS = ("ForwardEuler", "SSPRK22", "SSPRK104")
#: (top, policy, lagged, stepper, rows, icy): rows None, "step" or "time"
CASES = [
    ("B5", "", False, "ForwardEuler", None, False),
    ("B5", "", True, "SSPRK22", None, False),
    ("B6", "", False, "SSPRK104", None, False),
    ("B6-step", "", False, "ForwardEuler", None, False),
    ("B6-step", "", True, "SSPRK22", None, False),
    ("B6-step", "", True, "SSPRK104", "step", False),
    ("B5", "+B3-rate", False, "SSPRK22", None, False),
    ("B5", "+B3-eq", False, "SSPRK104", None, False),
    ("B5", "-no-ice", True, "ForwardEuler", None, True),
    ("B6", "+B3-eq", False, "SSPRK22", None, False),
    ("B6", "+B3-rate", False, "ForwardEuler", "time", False),
]
#: the cases that keep test_pallas_kernel.py's 256 columns in two tiles, one for each source
FULL_CASES = frozenset({("B5", "", False, "ForwardEuler"), ("B5", "+B3-rate", False, "SSPRK22")})


def mode_of(top, policy, lagged):
    """The mode's name: ``B2+`` when lagged, the top, the policy."""
    return ("B2+" if lagged else "") + top + policy


def run_name(top, policy, lagged, stepper, rows, icy=False):
    """The run's name: the mode's, the rows' suffix, the stepper."""
    return mode_of(top, policy, lagged) + {None: "", "step": "+B7", "time": "+B7-time"}[rows] + "@" + stepper


def case_id(case):
    return run_name(*case) + ("-icy" if case[5] else "")


def jax_land_model(top, policy, lagged, ncol=NCOL):
    """The JAX model of a case on ``ncol`` columns:
    ``test_torch_land_policies_b5.jax_model``, without a step policy too
    (``policy`` ""); a top ending in ``-water`` is the LandModel on
    ``test_torch_land_water.py``'s water-only soil (``policy`` "" or
    "-no-ice")."""
    if top.endswith("-water"):
        return jax_water_land(top[: -len("-water")], lagged, policy == "-no-ice", ncol=ncol)
    most = not top.endswith("-pond")
    jm = _jax_land(most=most, surface_update="step" if "-step" in top else "stage",
                   coefficient_update="step" if lagged else "stage")
    soil = jm.soil
    if most:
        soil = dataclasses.replace(soil, boundary_conditions=dataclasses.replace(
            soil.boundary_conditions, top=JAtmos(**COLD_ATMOS)))
    soil = dataclasses.replace(soil, domain=dataclasses.replace(soil.domain, batch_shape=(ncol,)),
                               **POLICIES.get(policy, {}))
    return soil if top == "B5" else dataclasses.replace(jm, soil=soil)


def case_ncol(top, policy, lagged, stepper):
    """The columns of a case's check: ``NCOL`` for ``FULL_CASES``, else
    ``CHECK_NCOL``."""
    return NCOL if (top, policy, lagged, stepper) in FULL_CASES else CHECK_NCOL


def case_inputs(top, policy, lagged, rows, icy, ncol=NCOL):
    """``(JAX model, start state, forcing rows or None, time grid or None)``
    on ``ncol`` columns."""
    jm = jax_land_model(top, policy, lagged, ncol)
    water = top.endswith("-water")
    Y = water_state(jm, icy) if water else cold_state(jm, icy)
    grid = TIME_GRID if rows == "time" else None
    forcing = None
    if rows:
        forcing = rain_rows(ncol=ncol) if water else forcing_rows(top, STEPS if grid is None else grid[2], ncol=ncol)
    return jm, Y, forcing, grid


def assert_matches(got, ref, jm):
    """``got`` against ``ref`` at rtol 1e-12 (atol 1e-16, the pond 1e-18);
    under EquilibriumFreezeThaw the cells past that bar lie in at most
    ``EQ_CELLS`` columns, each within ``ulp_allowance`` in the water
    contents and rho_l LH_f0 times it in rho_e_int."""
    from landhydrology_tpu.constants import default_earth_param_set as jps
    from landhydrology_tpu.models.soil.freeze_thaw import EquilibriumFreezeThaw as JEq

    soil = soil_of(jm)
    extra = ulp_allowance(soil) if isinstance(soil.freeze_thaw, JEq) else 0.0
    columns = set()
    for group, fields in ref.items():
        for k, v in fields.items():
            r, a = np.asarray(v), np.asarray(got[group][k])
            atol = 1e-18 if k == "h_s" else 1e-16
            bar = 1e-12 * np.abs(r) + atol
            past = np.abs(a - r) > bar
            if past.any() and extra and group == "soil":
                allowance = extra * (jps.rho_cloud_liq * jps.LH_f0 if k == "rho_e_int" else 1.0)
                np.testing.assert_array_less(np.abs(a - r)[past], bar[past] + allowance, err_msg=f"{group}/{k}")
                columns |= set(np.nonzero(past)[1].tolist())
                continue
            np.testing.assert_allclose(a, r, rtol=1e-12, atol=atol, err_msg=f"{group}/{k}")
    assert len(columns) <= EQ_CELLS, f"columns {sorted(columns)} past the strict bar"


def entry_of(policy):
    """The source of a case's instance under a new stepper."""
    return "land_policy_rk_kernel" if policy in POLICIES else "land_rk_kernel"


def check_rk_case(top, policy, lagged, stepper, rows, icy):
    """JAX's fused kernel (interpret mode) tracing ``stepper`` against the
    port's fused run (its plain version on the CPU): the run's name and
    source, no launch counted, the final state at ``assert_matches``'s bar;
    a freeze case forms and melts ice."""
    ncol = case_ncol(top, policy, lagged, stepper)
    jm, Y, forcing, grid = case_inputs(top, policy, lagged, rows, icy, ncol)
    fields = tuple(forcing or ())
    ref = jax_fused(jm, getattr(jts, stepper)(), dt=DT, steps_per_call=STEPS, tile_cols=tile_of(ncol), interpret=True,
                    forcing_fields=fields, forcing_time_grid=grid)(Y, T0, forcing=forcing)
    model = model_from_reference(jm, device="cpu")
    run = ck.make_fused_column_run(model, getattr(pts, stepper)(), dt=DT, steps_per_call=STEPS,
                                   forcing_fields=fields, forcing_time_grid=grid)
    assert run.name == run_name(top, policy, lagged, stepper, rows)
    assert ck._entry(run.mode, torch.float64)[0] == entry_of(policy)
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    rows_t = None if forcing is None else {k: torch.as_tensor(v) for k, v in forcing.items()}
    assert run(Yt, T0, forcing=rows_t) is Yt and ck.LAUNCHES == before
    ref = jax.tree_util.tree_map(np.asarray, ref)
    assert_matches(state_to_numpy(Yt), ref, jm)
    if policy in ("+B3-rate", "+B3-eq"):
        change = ref["soil"]["theta_i"] - np.asarray(Y["soil"]["theta_i"])
        assert int((change > 1e-8).sum()) > 100 and int((change < -1e-8).sum()) > 100
    if "surface" in ref:
        assert not np.array_equal(ref["surface"]["h_s"], np.asarray(Y["surface"]["h_s"]))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_land_explicit_steppers_match_jax_fused(case):
    check_rk_case(*case)


def cuda_rk_matches_plain(device, top, policy, lagged, stepper, rows, icy):
    """A case's instance on the card against its plain version, f64 at the
    bar of ``assert_matches``, its launch counted under the run's name."""
    jm, Y0, forcing, grid = case_inputs(top, policy, lagged, rows, icy)
    model = model_from_reference(jm, device=device)
    rows_t = None if forcing is None else {k: torch.as_tensor(v, device=device) for k, v in forcing.items()}
    Y = state_from_numpy(Y0, device=device)
    st = getattr(pts, stepper)()
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, DT, STEPS, Y, T0, forcing=rows_t,
                                                     forcing_time_grid=grid))
    run = ck.make_fused_column_run(model, st, dt=DT, steps_per_call=STEPS, forcing_fields=tuple(forcing or ()),
                                   forcing_time_grid=grid)
    before = ck.LAUNCHES[run.name]
    run(Y, T0, forcing=rows_t)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    assert_matches(state_to_numpy(Y), plain, jm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_land_explicit_steppers_match_plain(cuda_device, case):  # noqa: F811
    cuda_rk_matches_plain(cuda_device, *case)


#: the 48 land instances without MODE_COLUMNS: (top, policy, lagged)
LAND_MODES = ([(top, "", lagged) for top in ("B5", "B6", "B6-step", "B6-pond", "B6-step-pond")
               for lagged in (False, True)]
              + [(top, policy, lagged) for top in ("B5", "B6", "B6-step", "B6-pond", "B6-step-pond")
                 for policy in POLICIES for lagged in (False, True)]
              + [(top, policy, lagged) for top in ("B6-pond-water", "B6-step-pond-water")
                 for policy in ("", "-no-ice") for lagged in (False, True)])


def test_land_instances_under_the_new_steppers():
    """Each of the 48 land instances runs ForwardEuler, SSPRK22 and SSPRK104
    in one stage-table instance beside its SSPRK33 one (the stepper bits
    select none): the names ``<mode>@<stepper>``, distinct, the table twin
    of its SSPRK33 source and its scratch; a launch's argument struct
    carries the stepper's stage table and one BC row per stage."""
    names = set()
    for top, policy, lagged in LAND_MODES:
        model = model_from_reference(jax_land_model(top, policy, lagged), device="cpu")
        base = ck.make_fused_column_run(model, dt=DT, steps_per_call=STEPS)
        assert base.name == mode_of(top, policy, lagged)
        for stepper in NEW_STEPPERS:
            st = getattr(pts, stepper)()
            run = ck.make_fused_column_run(model, st, dt=DT, steps_per_call=STEPS)
            assert run.name == f"{base.name}@{stepper}" and run.name not in names
            names.add(run.name)
            assert run.mode & ~ck.MODE_RK == base.mode
            source = ck._entry(base.mode, torch.float32)[0]
            assert ck._entry(run.mode, torch.float32)[0] == source.replace("_kernel", "_rk_kernel")
            assert ck.scratch_fields(run.mode) == ck.scratch_fields(base.mode)
    assert len(LAND_MODES) == 48 and len(names) == 144
    model = model_from_reference(jax_land_model("B2+B6-step"[3:], "", True), device="cpu")
    run = ck.make_fused_column_run(model, pts.SSPRK104(), dt=DT, steps_per_call=STEPS)
    fields = [torch.zeros(NZ, NCOL, dtype=torch.float64) for _ in range(3)]
    args, _ = run.launch_args(fields, torch.zeros(NCOL, dtype=torch.float64), T0, torch.device("cpu"))
    table = ck.stage_table(pts.SSPRK104(), DT, torch.float64)
    assert args.n_stages == args.rows_per_step == len(table) == 10
    assert [args.stage_kind[s] for s in range(10)] == [row[0] for row in table]
    assert [args.stage_c[5 * s] for s in range(10)] == [row[4][0] for row in table]


@pytest.mark.parametrize("stepper", NEW_STEPPERS)
def test_per_column_land_instances_stay_refused(stepper):
    """``MODE_COLUMNS``'s land instances run every explicit stepper (B5 and
    B6 with per-column kinds or geometry from
    ``csrc/land_columns_kernel.cu``), and so do their plain-soil neighbours
    (B1's, the column-tile kernel's, ``csrc/tile_columns_kernel.cu``); since
    ROADMAP B queue item 2's
    remainder the implicit steppers under the MOST top take them too, no
    longer refused (``csrc/implicit_most_columns_kernel.cu``)."""
    from landhydrology_tpu_torch import BatchedBC, SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.domains import make_function_space

    soil = model_from_reference(jax_land_model("B5", "", False), device="cpu")
    land = model_from_reference(jax_land_model("B6", "", False), device="cpu")
    bcs = soil.boundary_conditions
    bottom = SoilComponentBC(energy=bcs.bottom.energy, hydrology=BatchedBC(kind=torch.zeros(NCOL, dtype=torch.int64)))
    kinds = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(top=bcs.top, bottom=bottom))
    assert ck.make_fused_column_run(kinds).name == "B5+kinds"
    run = ck.make_fused_column_run(kinds, getattr(pts, stepper)())
    assert run.name == f"B5+kinds@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "land_columns_kernel"
    plain_top = SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))
    plain = dataclasses.replace(kinds, boundary_conditions=SoilColumnBC(top=plain_top, bottom=bottom))
    run = ck.make_fused_column_run(plain, getattr(pts, stepper)())
    assert run.name == f"B1+kinds@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "tile_columns_kernel"
    from landhydrology_tpu_torch import BackwardEulerSoil

    run = ck.make_fused_column_run(kinds, BackwardEulerSoil(model=kinds, grid=make_function_space(
        soil.domain, torch.float64, "cpu")))
    assert run.name == "B4-be-soil+B5+kinds"
    assert ck._entry(run.mode, torch.float64)[0] == "implicit_most_columns_kernel"
    grid = make_function_space(soil.domain, torch.float64, "cpu")
    geometry = (torch.full((NCOL,), 0.125, dtype=torch.float64), grid.zc.expand(NZ, NCOL).contiguous())
    assert ck.make_fused_column_run(land, streamed_geometry=geometry).name == "B6+B8"
    run = ck.make_fused_column_run(land, getattr(pts, stepper)(), streamed_geometry=geometry)
    assert run.name == f"B6+B8@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "land_columns_kernel"
    flat_plain = dataclasses.replace(plain, boundary_conditions=SoilColumnBC(top=plain_top, bottom=bcs.bottom))
    run = ck.make_fused_column_run(flat_plain, getattr(pts, stepper)(), streamed_geometry=geometry)
    assert run.name == f"B1+B8@{stepper}" and ck._entry(run.mode, torch.float64)[0] == "tile_columns_kernel"
    from landhydrology_tpu_torch import TRBDF2Soil

    run = ck.make_fused_column_run(soil, TRBDF2Soil(model=soil, grid=grid), streamed_geometry=geometry)
    assert run.name == "B4-trbdf2+B5+B8"
    assert ck._entry(run.mode, torch.float64)[0] == "implicit_most_columns_kernel"
