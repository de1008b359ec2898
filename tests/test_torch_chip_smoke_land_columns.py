"""Phase 19 of ``chip_smoke.py`` (per-column BC kinds and geometry in the
land modes) without a GPU.

19c's cases give each family of land instances every explicit stepper;
``with_columns`` draws kinds at the faces the exchange leaves to the soil and
depths per column; 19c's check runs with the plain version as the kernel
(``plain_card``) and accepts it, and fails a kernel that reads the model's
uniform grid; 19a's storm at catchment.py's regolith depth ponds and closes
its water budget with each column's dz, and 19b's ``--atmos`` soil there
ponds; 19d's records carry every key of the kernels line.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu_torch import BatchedBC, VariableDepthColumn
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_chip_smoke import plain_card  # noqa: F401
from tests.test_torch_chip_smoke_land import COSTS, KEYS

F64 = torch.float64


def test_land_columns_cases_give_each_family_every_stepper():
    """The 48 land instances once each; each family (the surface modes
    without a policy, each policy, the water-only LandModel) meets the four
    explicit steppers, and each stepper meets rows and none; a third carry
    rows."""
    cases = cs.land_columns_cases()
    assert len(cases) == len({n for n, _, _ in cases}) == 48
    families = {}
    for name, stepper, rows in cases:
        family = "water" if "-water" in name else next(
            (p for p in ("+B3-rate", "+B3-eq", "-no-ice") if name.endswith(p)), "surface")
        families.setdefault(family, set()).add(stepper)
    assert families == {f: set(cs.COLUMNS_STEPPERS) for f in ("surface", "+B3-rate", "+B3-eq", "-no-ice", "water")}
    for stepper in cs.COLUMNS_STEPPERS:
        assert {rows for _, st, rows in cases if st == stepper} == {True, False}
    assert sum(rows for _, _, rows in cases) == 16


@pytest.mark.parametrize("name", ["B6-pond+B3-eq", "B5", "B2+B6-step-pond-water-no-ice"])
def test_with_columns_draws_kinds_and_depths(name):
    """Kinds at the bottom (hydrology of three kinds, energy of two where it
    is dynamic) and on a plain top's energy face, none on a face the
    exchange supplies; depths within 0.8-1.2 of the column's 2 m; the run's
    name ends in ``+kinds+B8``."""
    model, _, _, _, _ = cs.policy_variant(name, F64, "cpu")
    variant = cs.with_columns(model, cs.COLUMNS_SEED)
    soil = getattr(variant, "soil", variant)
    assert isinstance(soil.domain, VariableDepthColumn)
    height = np.broadcast_to(soil.domain.height, soil.domain.batch_shape)
    assert height.min() >= 1.6 and height.max() <= 2.4 and height.std() > 0.05
    bottom, top = soil.boundary_conditions.bottom, soil.boundary_conditions.top
    assert isinstance(bottom.hydrology, BatchedBC) and set(bottom.hydrology.kind.tolist()) == {0, 1, 2}
    water = "-water" in name
    assert isinstance(bottom.energy, BatchedBC) != water
    assert isinstance(getattr(top, "energy", None), BatchedBC) == ("-pond" in name and not water)
    assert not isinstance(getattr(top, "hydrology", None), BatchedBC)
    assert ck.make_fused_column_run(variant).name == name + "+kinds+B8"


@pytest.mark.parametrize("name,stepper,rows", [("B6-step+B3-eq", "SSPRK104", True),
                                               ("B2+B5+B3-rate", "SSPRK33", False),
                                               ("B6-pond-water", "ForwardEuler", True),
                                               ("B2+B6-pond-no-ice", "SSPRK22", False)])
def test_land_columns_check_passes_the_plain_version(plain_card, monkeypatch, name, stepper, rows):  # noqa: F811
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    err, shares, grown, melted, plain_ms, probes = cs.cold_check(ck, name, F64, "cpu", rows=rows, tag="19c",
                                                                 stepper=stepper, columns=True)
    assert err == 0.0 and "vartheta_l" in shares and plain_ms > 0.0
    assert (grown > 0 and melted > 0) if "B3" in name else grown == melted == 0
    assert (probes is None) == ("-pond" in name)


def test_land_columns_check_fails_a_kernel_on_the_uniform_grid(plain_card, monkeypatch):  # noqa: F811
    """A "kernel" that steps the model on its 2 m columns (the uniform grid,
    without the per-column depths) fails 19c's check."""
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    call = ck.FusedColumnRun.__call__

    def uniform(self, Y, t0, forcing=None, dt_run=None):
        from landhydrology_tpu_torch import Column

        soil = self.soil
        flat = dataclasses.replace(soil, domain=Column(zlim=(-2.0, 0.0), nelements=soil.domain.nelements,
                                                       batch_shape=soil.domain.batch_shape))
        self.model = flat if self.model is soil else dataclasses.replace(self.model, soil=flat)
        return call(self, Y, t0, forcing=forcing, dt_run=dt_run)

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", uniform)
    with pytest.raises(AssertionError):
        cs.cold_check(ck, "B6", F64, "cpu", tag="19c", stepper="SSPRK22", columns=True)


@pytest.mark.parametrize("case,atmos", [("B6-pond-water", False), ("B2+B6-step-pond-water", False),
                                        ("B2+B6-step", True), ("B6", True)])
def test_storm_at_its_regolith_depth(plain_card, monkeypatch, capsys, case, atmos):  # noqa: F811
    """19a and 19b on an 8 x 8 grid: catchment.py's depths (0.5-2 m) on the
    fused engine, one launch counted under the ``+B8`` name, held to the
    plain version on every 4th column, a pond formed, the water-only
    soil's budget closed with each column's dz; the record names its
    source."""
    for name, value in (("STORM_SIDE", 8), ("STORM_STRIDE", 4), ("STORM_STEPS", 8)):
        monkeypatch.setattr(cs, name, value)
    land, Y = cs.build_storm(F64, "cpu", case, variable_depth=True, atmos=atmos)
    height = np.broadcast_to(land.soil.domain.height, (64,))
    assert height.min() == pytest.approx(0.5) and height.max() == pytest.approx(2.0)
    assert ("rho_e_int" in Y["soil"]) == atmos
    record = cs.storm_path(ck, COSTS, "smi", F64, "cpu", case, variable_depth=True, atmos=atmos,
                           tag="19b" if atmos else "19a")
    assert set(record) - {"plain_at"} == KEYS and record["max_abs_err"] == 0.0 and record["launches"] == 1
    source = "land_kernel.cu" if case == "B6" else "land_columns_kernel.cu"
    assert record["name"].endswith(f", {case}+B8>") and record["source"].endswith(source)
    out = capsys.readouterr().out
    assert "a pond in" in out and ("no rain budget" in out) == atmos
    assert "each column's dz" in out or atmos


def test_land_columns_records(plain_card, monkeypatch, capsys):  # noqa: F811
    """19c and 19d over a shortened list: the records carry every key of
    the kernels line, their names the instance with ``+kinds+B8``, rows and
    its stepper, their kernel time a launch at the narrowed width."""
    for name, value in (("COLD_NCOL", 24), ("NZ", 8), ("NCOL", 32), ("STORM_SIDE", 4), ("COLD_PROBE_STRIDE", 8),
                        ("LAND_RK_MODES", ("B2+B6-step", "B5+B3-eq", "B6-pond-water-no-ice", "B6"))):
        monkeypatch.setattr(cs, name, value)
    records = cs.land_columns_checks(ck, COSTS, "smi", F64, "cpu")
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == [
        "B2+B6-step+kinds+B8+B7@ForwardEuler", "B5+B3-eq+kinds+B8@SSPRK22", "B6-pond-water-no-ice+kinds+B8",
        "B6+kinds+B8+B7@SSPRK104"]
    for r in records:
        assert set(r) - {"plain_at"} == KEYS and r["max_abs_err"] == 0.0 and r["plain_ms"] > 0.0
        assert r["bound_ms"] > 0.0
    assert [r["source"].rsplit("/", 1)[1] for r in records] == [
        "land_columns_kernel.cu", "land_policy_columns_kernel.cu", "land_policy_columns_kernel.cu",
        "land_columns_kernel.cu"]
    timed = [line for line in capsys.readouterr().out.splitlines() if "[19d time] float64 " in line]
    assert len(timed) == 4 and all(f" {cs.COLUMNS_TIMED_STEPS} steps " in line for line in timed)


def test_registers_name_the_column_instances(tmp_path):
    """The ptxas report parser names a land mode's stage-table instance with
    ``MODE_COLUMNS`` ``table:<mode>+kinds+B8``."""
    mode = ck.MODE_LAND | ck.MODE_COLUMNS | ck.MODE_FREEZE_EQ
    report = (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118land_column_kernelIfLi{mode}ELb1EEEv10"
              "KernelArgsff' for 'sm_90a'\nptxas info    : Used 99 registers, used 0 barriers\n")
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == "land_policy_columns_kernel" else "")
    assert cs.registers(ck, libs) == {"f32, table:B6-pond+B3-eq+kinds+B8": 99}
    assert cs.kernel_of(ck, mode | ck.MODE_SSPRK22, F64) == (
        "land_column_kernel", "landhydrology_tpu_torch/csrc/land_policy_columns_kernel.cu")


def test_drive_path_held_by_a_shorter_launch(plain_card, capsys):  # noqa: F811
    """The plain launches phase 19 cut: ``drive_path(plain_steps=...)``
    runs the whole path (its saves checked, its final state returned) and
    holds a launch of ``plain_steps`` steps from the start state to the
    plain version; phase 6's record of the path then carries that launch's
    plain time under ``plain_at``, and its MOST probes count the shorter
    launch's solves."""
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.timestepping import SSPRK33

    model, Y0 = cs.build_land_variant(16, F64, "cpu", seed=29, case="B5", cold=True)
    Ya = {"zc": make_function_space(model.domain, F64, "cpu").zc, "soil": {}}
    final, launches, err, _ = cs.drive_path(ck, model, Y0, Ya, 2.0, 8, 4, "19 cut", ("vartheta_l", "rho_e_int"),
                                            plain_steps=2)
    whole = cs._np(ck.fused_column_run_plain(model, SSPRK33(), 2.0, 8, Y0, 0.0))
    assert launches == 2 and err == 0.0 and all(np.array_equal(final[k], whole[k]) for k in whole)
    key = cs._path_key(model, Y0, 2.0, 4, SSPRK33())
    assert cs._PATH_CHECKED_STEPS[key] == 2 and len(cs._PATH_PLAIN_MS[key]) == 1
    assert "held by a launch of 2 steps" in capsys.readouterr().out
    (record,) = cs.time_paths(ck, COSTS, "smi", [(model, Y0, 2.0, 4, launches, err, SSPRK33())])
    assert record["plain_at"] == "the path's check: nz=16 x 16, 2 steps" and set(record) - {"plain_at"} == KEYS


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
def test_forced_combination_held_by_its_first_rows_in_f64(plain_card, dtype):  # noqa: F811
    """Phase 11's other modes with rows: one counted launch of
    ``FORCED_SPC`` rows; in f64 (phase 19's cut) held to the plain version
    by a launch of its first ``FORCED_COMBO_CHECKED`` rows, which the
    record's ``plain_at`` names, in f32 by the launch itself."""
    record = cs.forced_combination(ck, COSTS, "smi", "B6-step", dtype, "cpu", ncol=16)
    assert record["name"].endswith(", B6-step+B7>") and record["launches"] == 1 and record["max_abs_err"] == 0.0
    assert set(record) - {"plain_at"} == KEYS
    assert record.get("plain_at") == (f"11: nz={cs.FORCED_NZ} x 16, {cs.FORCED_COMBO_CHECKED} rows" if dtype == F64
                                      else None)
