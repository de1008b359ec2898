"""Phase 17 of ``chip_smoke.py`` (cold forced and water-only land) without a
GPU.

The builders make the instances they name: the 30 land policy instances
with forcing rows, the 8 water-only LandModel instances and the 24 implicit
policy instances of 17a; the checks run with the plain version as the
kernel (``plain_card``) and accept it, and fail a kernel that drops the
rows; 17b's cold forced reanalysis, 17c's storm and 17d's implicit path
form ice or a pond, close their water budgets and count their launches on
narrow widths; 17e's records carry every key of the kernels line.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu_torch.models.soil.boundary import PrescribedAtmosForcing
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_torch_chip_smoke import plain_card  # noqa: F401
from tests.test_torch_chip_smoke_land import COSTS, KEYS

F64, F32 = torch.float64, torch.float32


def test_mode_lists_name_the_new_instances_and_their_sources():
    """17a's lists: the 8 water-only and 24 implicit instances, each once,
    each built by ``policy_variant`` in the mode it names, from its source;
    the row cases among them."""
    assert len(set(cs.WATER_MODES)) == 8 and len(set(cs.IMPLICIT_MODES)) == 24
    assert set(cs.COLD_TIME_MODES) <= set(cs.COLD_MODES) and set(cs.IMPLICIT_ROW_MODES) <= set(cs.IMPLICIT_MODES)
    assert set(cs.STORM_PATHS) <= set(cs.WATER_MODES) and set(cs.COLD_IMPLICIT_PATHS) <= set(cs.IMPLICIT_MODES)
    sources = {}
    for name in cs.WATER_MODES + cs.IMPLICIT_MODES:
        model, Y, stepper, dt, steps = cs.policy_variant(name, F64, "cpu")
        run = ck.make_fused_column_run(model, stepper)
        assert run.name == name and steps == (cs.IMPLICIT_STEPS if name.startswith("B4-") else cs.cold_steps(F64))
        assert dt == (cs.IMPLICIT_DT if name.startswith("B4-") else 2.0)
        sources.setdefault(ck._entry(run.mode, F64)[0], []).append(name)
    assert len(sources["implicit_most_kernel"]) == 21 and len(sources["implicit_policy_kernel"]) == 3
    assert len(sources["land_kernel"]) == len(sources["land_policy_kernel"]) == 4
    assert cs.implicit_case("B4-be-soil-no-ice+B2+B5") == ("BackwardEulerSoil", "B2+B5-no-ice")
    assert cs.implicit_case("B4-be-richards-no-ice+B2") == ("BackwardEulerRichards", "B2+B6-pond-no-ice")


def test_policy_rows_follow_the_top():
    """Rows of a MOST top carry theta_atm within 8 K of 273.15 K, those of a
    LandModel a rain rate; a water-only LandModel takes rain alone."""
    for name, fields in (("B5+B3-rate", {"theta_atm"}), ("B6-step+B3-eq", {"theta_atm", "precipitation"}),
                         ("B6-pond-no-ice", {"precipitation"}), ("B6-pond-water", {"precipitation"}),
                         ("B4-trbdf2+B3-rate+B5", {"theta_atm"})):
        model = cs.policy_variant(name, F64, "cpu")[0]
        rows = cs.policy_rows(model, 3, seed=37)
        assert set(rows) == fields and all(tuple(v.shape) == (3, cs.COLD_NCOL) for v in rows.values())
        if "theta_atm" in rows:
            assert float((rows["theta_atm"] - 273.15).abs().max()) <= 8.0
    soil = cs.policy_variant("B6-pond-water", F64, "cpu")[0].soil
    assert not isinstance(soil.boundary_conditions.top, PrescribedAtmosForcing) and soil.freeze_thaw is None


@pytest.mark.parametrize("name,kw", [
    ("B6-step+B3-eq", dict(rows=True)), ("B5+B3-rate", dict(rows=True, time_grid=cs.COLD_TIME_GRID)),
    ("B2+B6-step-pond-water-no-ice", dict()), ("B6-pond-water", dict(rows=True)),
    ("B4-be-soil-no-ice+B2+B5", dict(icy=True)),
    ("B4-trbdf2+B2+B3-eq+B5", dict(rows=True, time_grid=(0.0, 100.0, 3))),
])
def test_cold_check_passes_the_plain_version(plain_card, monkeypatch, name, kw):  # noqa: F811
    """17a's check with the plain version as the kernel: error 0; ice grew
    in some columns and melted in others under freeze-thaw, and stayed
    without it."""
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    err, shares, grown, melted, _, _ = cs.cold_check(ck, name, F64, "cpu", tag="17a", **kw)
    assert err == 0.0 and "vartheta_l" in shares
    freeze = "B3" in name
    assert (grown > 0 and melted > 0) if freeze else grown == melted == 0


def test_cold_check_fails_a_kernel_that_drops_the_rows(plain_card, monkeypatch):  # noqa: F811
    """A "kernel" that steps on the model's own atmosphere, not the rows,
    fails 17a's check."""
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    call = plain_card

    def no_rows(self, Y, t0, forcing=None, dt_run=None):
        out = call(ck.FusedColumnRun(self.model, self.stepper, self.dt, self.steps_per_call, self.tile_cols), Y, t0)
        ck.LAUNCHES[self.name] += 1
        return out

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", no_rows)
    with pytest.raises(AssertionError):
        cs.cold_check(ck, "B5+B3-rate", F64, "cpu", rows=True, tag="17a")


def test_cold_forced_checks_return_the_records_inputs(plain_card, monkeypatch):  # noqa: F811
    """17a over shortened lists: the new instances' checks without rows, by
    name; 16a's checks of the land policy instances with step-indexed rows
    (``cold_checks``, which main runs before phase 17 where phase 16 does
    not) return theirs the same way."""
    monkeypatch.setattr(cs, "COLD_NCOL", 32)
    monkeypatch.setattr(cs, "COLD_MODES", ("B6-pond-no-ice",))
    monkeypatch.setattr(cs, "COLD_TIME_MODES", ())
    monkeypatch.setattr(cs, "WATER_MODES", ("B6-pond-water-no-ice",))
    monkeypatch.setattr(cs, "IMPLICIT_MODES", ("B4-be-richards+B2+B5",))
    monkeypatch.setattr(cs, "IMPLICIT_ROW_MODES", ())
    new = cs.cold_forced_checks(ck, F64, "cpu")
    with_rows = cs.cold_checks(ck, F64, "cpu")
    assert set(new) == {"B6-pond-water-no-ice", "B4-be-richards+B2+B5"} and set(with_rows) == {"B6-pond-no-ice"}
    assert all(err == 0.0 and ms > 0.0 for err, ms in list(new.values()) + list(with_rows.values()))


def test_storm_builder_is_catchments_soil():
    """17c's model: catchment.py's per-column soils (n 1.8-3.0, alpha
    2.0-3.5, Ksat 10**(-6.5 + 1.2 z_norm) with noise), nu 0.42, zero-flux
    faces, T prescribed, its storm peaking at 40 mm/h at t = 1,800 s; no
    routing, a uniform depth."""
    land, Y = cs.build_storm(F64, "cpu", "B2+B6-step-pond-water-no-ice", side=8)
    soil = land.soil
    hm = soil.hydrology_model.hydraulic_model
    assert tuple(hm.n.shape) == (64,) and 1.8 <= float(hm.n.min()) and float(hm.n.max()) <= 3.0 + 1e-12
    assert 2.0 <= float(hm.alpha.min()) and float(hm.alpha.max()) <= 3.5 + 1e-12
    assert float(soil.soil_param_set.nu) == 0.42 and land.surface.runoff is None
    assert soil.coefficient_update == "step" and soil.assume_no_ice and land.surface_update == "step"
    peak = float(cs.storm_precipitation(torch.tensor(1800.0, dtype=F64)))
    assert peak == pytest.approx(40.0 / 1000.0 / 3600.0, rel=1e-15)
    assert float(cs.storm_precipitation(torch.tensor(1800.0 + 576.0, dtype=F64))) == pytest.approx(peak / np.e)
    assert ck.make_fused_column_run(land).name == "B2+B6-step-pond-water-no-ice"
    assert float(Y["soil"]["vartheta_l"].min()) == 0.15 and float(Y["surface"]["h_s"].max()) == 0.0


def test_storm_path_ponds_and_closes_its_budget(plain_card, monkeypatch, capsys):  # noqa: F811
    """17c on 8 x 8 columns with the plain version as the kernel, a launch
    of 8 steps: one launch, a pond forms, the budget closes, the record
    carries every key."""
    monkeypatch.setattr(cs, "STORM_SIDE", 8)
    monkeypatch.setattr(cs, "STORM_STRIDE", 4)
    monkeypatch.setattr(cs, "STORM_STEPS", 8)
    record = cs.storm_path(ck, COSTS, "smi", F64, "cpu", "B6-pond-water")
    assert set(record) - {"plain_at"} == KEYS and record["launches"] == 1 and record["max_abs_err"] == 0.0
    assert record["name"] == "land_column_kernel<f64, B6-pond-water>"
    out = capsys.readouterr().out
    assert "a pond in" in out and "water budget" in out


def test_cold_forced_path_forms_ice_and_closes_its_budget(plain_card, monkeypatch, tmp_path, capsys):  # noqa: F811
    """17b on 64 columns in f32 with the plain version as the kernel, 24
    steps: the forcing from a file in two windows, two launches, equal to
    the segment launch by launch, ice formed, the budget closed, the
    record's keys."""
    from landhydrology_tpu_torch.runtime import write_forcing

    monkeypatch.setattr(cs, "FORCED_NCOL", 64)
    monkeypatch.setattr(cs, "FORCED_STRIDE", 16)
    monkeypatch.setattr(cs, "COLD_FORCED_STEPS", 24)
    monkeypatch.setattr(cs, "COLD_FORCED_WINDOW", 12)
    monkeypatch.setattr(cs, "FORCED_SPC", 12)
    times, rows = cs.reanalysis_forcing(cs.COLD_FORCED_STEPS, 64, cs.FORCED_DT)
    rows["theta_atm"] = rows["theta_atm"] - np.float32(cs.COLD_FORCED_SHIFT)
    path = str(tmp_path / "forcing.bin")
    write_forcing(path, times, rows)
    record = cs.cold_forced_path(ck, COSTS, "smi", F32, "cpu", "B2+B6-step+B3-rate", path)
    assert set(record) - {"plain_at"} == KEYS and record["launches"] == 2
    assert record["name"] == "land_column_kernel<f32, B2+B6-step+B3-rate+B7>"
    out = capsys.readouterr().out
    assert "equal bit for bit" in out and "ice in" in out and "water budget" in out


def test_cold_implicit_path_forms_ice(plain_card, monkeypatch):  # noqa: F811
    """17d on 32 columns with the plain version as the kernel: one launch of
    8 steps, ice formed; the path goes to phase 6 with its stepper."""
    monkeypatch.setattr(cs, "NCOL", 32)
    model, Y0, dt, spc, launches, err, st = cs.cold_implicit_path(ck, cs._load_golden_config(), F64, "cpu",
                                                                  "B4-trbdf2+B3-rate+B5")
    assert (dt, spc, launches, err) == (cs.IMPLICIT_DT, cs.COLD_IMPLICIT_STEPS, 1, 0.0)
    assert ck.make_fused_column_run(model, st).name == "B4-trbdf2+B3-rate+B5"


@pytest.mark.parametrize("fault", [None, "half step", "top cell warm"])
def test_cold_implicit_path_holds_the_f32_equilibrium_path_by_what_the_projection_keeps(plain_card, monkeypatch,  # noqa: F811
                                                                                         capsys, fault):
    """17d's f32 equilibrium path: its change bar holds the total water and
    rho_e_int, which the projection does not re-partition, at 0.1 of their
    change, each of which must move.  The plain version as the kernel
    passes; a "kernel" that takes half of each step, or whose state's top
    cell is 0.2 K warmer after the launch, fails the change bar alone (the
    state bars of ``_check_freeze`` left out: at full width they let up to
    41 cells pass one projection's allowance)."""
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity

    monkeypatch.setattr(cs, "NCOL", 32)
    call = plain_card

    def faulty(self, Y, t0, forcing=None, dt_run=None):
        out = call(self, Y, t0, forcing=forcing, dt_run=self.dt / 2 if fault == "half step" else dt_run)
        if fault == "top cell warm":
            soil = self.model
            ps = soil.earth_param_set
            rho_c = volumetric_heat_capacity(out["soil"]["vartheta_l"][-1], out["soil"]["theta_i"][-1],
                                             soil.soil_param_set.rho_c_ds, ps)
            out["soil"]["rho_e_int"][-1] += 0.2 * rho_c
        ck.LAUNCHES[self.name] += 1
        return out

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", faulty)
    run = lambda: cs.cold_implicit_path(ck, cs._load_golden_config(), F32, "cpu",  # noqa: E731
                                        "B4-trbdf2+B2+B3-eq+B5")
    if fault is None:
        run()
        assert "water" in capsys.readouterr().out
    else:
        monkeypatch.setattr(cs, "_check_freeze", lambda *a, **k: (0.0, 0.0))
        with pytest.raises(AssertionError, match="water|rho_e_int"):
            run()


def test_time_at_width_records(plain_card, monkeypatch):  # noqa: F811
    """17e: an implicit MOST instance (probes of one step of the plain
    version) and a land policy instance with rows (the probes given), each
    record with every key and 17a's error and plain time."""
    monkeypatch.setattr(cs, "NCOL", 32)
    monkeypatch.setattr(cs, "COLD_PROBE_STRIDE", 8)
    gc = cs._load_golden_config()
    soil, Y0, _, _ = cs.build_cold_land(gc, F64, "cpu", "B2+B5+B3-eq")
    st = cs.implicit("BackwardEulerSoil", soil, 2)
    record = cs.time_at_width(ck, COSTS, "smi", soil, Y0, st, cs.IMPLICIT_DT, 0.0, "B4-be-soil+B2+B3-eq+B5", (2e-9, 5.0))
    assert set(record) - {"plain_at"} == KEYS and record["plain_ms"] == 5.0 and record["max_abs_err"] == 2e-9
    assert record["source"] == "landhydrology_tpu_torch/csrc/implicit_most_kernel.cu"
    land, Y0, _, dt = cs.build_cold_land(gc, F64, "cpu", "B6+B3-rate")
    rows = {"theta_atm": torch.full((cs.COLD_TIMED_STEPS, 32), cs.COLD_THETA_ATM, dtype=F64),
            "precipitation": torch.full((cs.COLD_TIMED_STEPS, 32), 8e-6, dtype=F64)}
    record = cs.time_at_width(ck, COSTS, "smi", land, Y0, SSPRK33(), dt, 0.0, "B6+B3-rate+B7", (0.0, 1.0),
                              forcing=rows, probes=90.0)
    assert record["name"] == "land_column_kernel<f64, B6+B3-rate+B7>" and np.isfinite(record["bound_ms"])


def test_plain_solves_count_the_eager_phase_change_evaluations():
    """The plain version's MOST solves per step: the kernel's, and the rhs
    evaluations of theta_i's phase change that the eager implicit steppers
    take (TR-BDF2 under rate freeze-thaw, BackwardEulerSoil under either)."""
    most = ck.MODE_MOST
    assert cs.plain_solves(ck, most | ck.MODE_TRBDF2 | ck.MODE_FREEZE_RATE, 2) == 9 + 4
    assert cs.plain_solves(ck, most | ck.MODE_TRBDF2 | ck.MODE_FREEZE_EQ | ck.MODE_LAGGED, 2) == 9
    assert cs.plain_solves(ck, most | ck.MODE_BE_SOIL | ck.MODE_FREEZE_EQ, 2) == 4 + 1
    assert cs.plain_solves(ck, most | ck.MODE_BE_RICHARDS | ck.MODE_FREEZE_RATE, 2) == 3
    assert cs.plain_solves(ck, most, 2) == 3


def test_water_only_exchange_counts_no_temperature():
    """The bound of a water-only LandModel's exchange leaves out the T
    diagnosis the coupled one counts."""
    land = ck.MODE_LAND | ck.MODE_SURFACE_STEP
    water = cs.column_step_ops(ck, land | ck.MODE_WATER, F64)
    coupled = cs.column_step_ops(ck, land, F64)
    assert coupled["op"] - water["op"] == cs._TEMP["op"] and coupled["div"] - water["div"] == cs._TEMP["div"]
    assert dataclasses.is_dataclass(cs.build_water_variant(16, F64, "cpu", 29, "B6-pond-water")[0])


def test_b9_f32_modes_are_b9_modes(monkeypatch):
    """14b's subset names modes ``b9_modes`` builds in both float types,
    among them the lagged freeze-thaw SSPRK33 modes, whose f32 instances no
    other phase holds to their plain version, the implicit steppers and the
    MOST top."""
    monkeypatch.setattr(cs, "GRAD_NCOL", 8)
    for dtype in (F64, F32):
        names = {ck.make_fused_column_run(m, st).name for m, _, st, _ in
                 cs.b9_modes(cs._load_golden_config(), dtype, "cpu")}
        assert cs.B9_MODES <= names
    assert {"B2+B3-rate", "B2+B3-eq", "B4-trbdf2+B3-rate", "B5", "B4-trbdf2+B5"} <= cs.B9_MODES
