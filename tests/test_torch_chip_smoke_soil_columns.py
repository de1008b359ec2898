"""Phase 20 of ``chip_smoke.py`` (per-column BC kinds and geometry in the
plain-soil modes under every explicit stepper and implicit step policy)
without a GPU.

20c's cases hold each of the 44 new instances once (two again with PCR),
each explicit family meeting every stepper; ``build_grid_variant`` builds
each mode with kinds at both faces and depths, the freeze-thaw and no-ice
ones from a cold start; 20c's check runs with the plain version as the
kernel (``plain_card``) and accepts it, and fails a kernel that reads the
model's uniform grid; 20a's regional hour with no ice leaves the columns
B1's leaves; 20b's run file names the instance and its records carry every
key of the kernels line.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import contextlib
import dataclasses
import io
import json
import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu_torch import BatchedBC, VariableDepthColumn
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_chip_smoke import plain_card  # noqa: F401
from tests.test_torch_chip_smoke_land import COSTS, KEYS

F64 = torch.float64


def test_soil_columns_cases_hold_every_new_instance():
    """16 explicit and 28 implicit instances, each once with Thomas solves
    (two also with PCR); each explicit family (coupled, water-only,
    heat-only) meets the four steppers, and B1, B2, B3-rate and B1-water,
    whose SSPRK33 ``MODE_COLUMNS`` instance is ``column_kernel.cu``'s, never
    meet SSPRK33."""
    cases = cs.soil_columns_cases()
    assert len(cases) == 16 + 28 + 2
    explicit = [(m, st) for m, st, tri in cases if tri is None]
    assert len({m for m, _ in explicit}) == 16
    assert len({m for m, _, tri in cases if tri == "thomas"}) == 28
    families = {}
    for mode, stepper in explicit:
        family = "water" if "-water" in mode else "heat" if "-heat" in mode else "coupled"
        families.setdefault(family, set()).add(stepper)
    assert families == {f: set(cs.COLUMNS_STEPPERS) for f in ("coupled", "water", "heat")}
    assert all(st != "SSPRK33" for m, st in explicit if m in ("B1", "B2", "B3-rate", "B1-water"))


@pytest.mark.parametrize("mode,stepper,tridiag", cs.soil_columns_cases(), ids=lambda c: str(c))
def test_soil_columns_variant_builds_its_instance(mode, stepper, tridiag):
    """Each case builds its mode with kinds and depths from the source of
    the new instance; the freeze-thaw and no-ice modes start cold, with ice
    (the explicit no-ice ones on the icy state, vartheta_l past nu -
    theta_i; the implicit ones not, where one-ulp changes of the start state
    move the plain version past the f64 bar)."""
    model, Y, st, dt, name = cs.soil_columns_variant(12, F64, "cpu", 7, mode, stepper, tridiag)
    run = ck.make_fused_column_run(model, st, dt=dt)
    assert run.name == name and name.split("@")[0].endswith("+kinds+B8")
    assert ck._entry(run.mode, F64)[0] == ("implicit_columns_kernel" if tridiag
                                          else "tile_columns_kernel" if mode in ("B1", "B1-no-ice")
                                          else "rk_columns_kernel")
    assert isinstance(model.domain, VariableDepthColumn)
    faces = [getattr(model.boundary_conditions, f) for f in ("top", "bottom")]
    assert all(isinstance(getattr(face, "energy" if "-heat" in mode else "hydrology"), BatchedBC) for face in faces)
    assert dt == (cs.SOIL_IMPLICIT_DT if tridiag else 2.0 if "B3" in mode else 0.25)
    if "B3" in mode or "-no-ice" in mode and "-heat" not in mode:
        ice = Y["soil"]["theta_i"]
        assert float(ice.max()) >= 0.02
        if "-no-ice" in mode:
            nu = torch.as_tensor(model.soil_param_set.nu)
            assert bool((Y["soil"]["vartheta_l"] > nu - ice).any()) == (tridiag is None)


def test_soil_columns_checks_pass_the_plain_version(plain_card, monkeypatch, capsys):  # noqa: F811
    """20c and 20d over a shortened list: the plain version standing in for
    the kernel passes the checks; 20d's records (all but the PCR repeat's)
    carry every key of the kernels line, their names the instance with
    ``+kinds+B8`` and its stepper."""
    monkeypatch.setattr(cs, "SOIL_COLUMNS_NCOL", 24)
    monkeypatch.setattr(cs, "GRID_TIMED_NCOL", 32)
    monkeypatch.setattr(cs, "GRID_TIMED_NZ", 8)
    cases = [("B2+B3-eq", "ForwardEuler", None), ("B1-heat-no-ice", "SSPRK22", None),
             ("B4-be-soil-no-ice+B2", None, "thomas"), ("B4-trbdf2+B2+B3-rate", None, "pcr")]
    monkeypatch.setattr(cs, "soil_columns_cases", lambda: cases)
    checked = cs.soil_columns_checks(ck, F64, "cpu")
    records = cs.soil_columns_times(ck, COSTS, "smi", F64, "cpu", checked)
    assert [c[3] for c in checked] == [
        "B2+B3-eq+kinds+B8@ForwardEuler", "B1-heat-no-ice+kinds+B8@SSPRK22", "B4-be-soil-no-ice+B2+kinds+B8",
        "B4-trbdf2-pcr+B2+B3-rate+kinds+B8"]
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == [
        "B2+B3-eq+kinds+B8@ForwardEuler", "B1-heat-no-ice+kinds+B8@SSPRK22", "B4-be-soil-no-ice+B2+kinds+B8"]
    for r in records:
        assert set(r) - {"plain_at"} == KEYS and r["max_abs_err"] == 0.0 and r["bound_ms"] > 0.0
    assert [r["source"].rsplit("/", 1)[1] for r in records] == [
        "rk_columns_kernel.cu", "rk_columns_kernel.cu", "implicit_columns_kernel.cu"]
    out = capsys.readouterr().out
    assert "B4-trbdf2-pcr+B2+B3-rate+kinds+B8 0.00e+00" in out and "ice grew in" in out


def test_soil_columns_check_fails_a_kernel_on_the_uniform_grid(plain_card, monkeypatch):  # noqa: F811
    """A "kernel" that steps the model on one uniform depth (without the
    per-column depths) fails 20c's check."""
    monkeypatch.setattr(cs, "SOIL_COLUMNS_NCOL", 24)
    monkeypatch.setattr(cs, "soil_columns_cases", lambda: [("B1-no-ice", "SSPRK104", None)])
    call = ck.FusedColumnRun.__call__

    def uniform(self, Y, t0, forcing=None, dt_run=None):
        from landhydrology_tpu_torch import Column

        soil = self.model
        self.model = dataclasses.replace(soil, domain=Column(zlim=(-2.0, 0.0), nelements=soil.domain.nelements,
                                                             batch_shape=soil.domain.batch_shape))
        return call(self, Y, t0, forcing=forcing, dt_run=dt_run)

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", uniform)
    with pytest.raises(AssertionError):
        cs.soil_columns_checks(ck, F64, "cpu")


def test_regional_hour_without_ice_leaves_b1s_columns(plain_card, monkeypatch, capsys):  # noqa: F811
    """20a on a narrowed grid: the hour with ``assume_no_ice`` launches
    ``B1-no-ice+kinds`` (and ``+B8`` on the twin), whose diverged columns
    are those of the B1 hour run for them, and the records name the
    column-tile kernel's source (20a) and ``rk_columns_kernel.cu`` (20b);
    20b's run file runs in process, its first save equal to the file's
    first launch; 20e's checks of the column-tile kernel run."""
    for name, value in (("GRID_NZ", 6), ("GRID_NCOL", 96), ("GRID_SPC", 6), ("GRID_STEPS", 12),
                        ("SOIL_CLI_STRIDE", 8)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "REGIONAL_DIVERGED", {})
    monkeypatch.setattr(cs, "soil_columns_checks", lambda *a, **k: [])
    monkeypatch.setattr(cs, "soil_columns_times", lambda *a, **k: [])
    from landhydrology_tpu_torch import cli

    def run_cli(path, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["run", path, "--device", "cpu"]) == 0
        out = buf.getvalue()
        launches = json.loads(out.split("kernel launches: ", 1)[1].splitlines()[0])
        return out, launches, float(re.search(r"cells in ([0-9.e+-]+) s \(host clock\)", out).group(1))

    monkeypatch.setattr(cs, "_start_cli", lambda path: path)  # the CLI runs in process when 20b collects it
    monkeypatch.setattr(cs, "_finish_cli", run_cli)
    records = cs.soil_columns_phase(ck, COSTS, "smi", "cpu", 0.0)
    names = [r["name"].split(", ", 1)[1][:-1] for r in records]
    assert names == ["B1-no-ice+kinds", "B1-no-ice+kinds+B8"] * 2 + ["B2+kinds+B8@SSPRK104"]
    assert [r["source"].rsplit("/", 1)[1] for r in records] == ["tile_columns_kernel.cu"] * 4 + ["rk_columns_kernel.cu"]
    assert all(set(r) - {"plain_at"} == KEYS for r in records) and records[-1]["launches"] == cs.SOIL_CLI_LAUNCHES
    assert {k[2] for k in cs.REGIONAL_DIVERGED} == {False, True}
    for (dtype, depth, no_ice), cols in cs.REGIONAL_DIVERGED.items():
        assert np.array_equal(cols, cs.REGIONAL_DIVERGED[(dtype, depth, not no_ice)])
    out = capsys.readouterr().out
    assert out.count("diverged columns with no ice") == 4 and "NOT the same" not in out
    assert "its first save equal bit for bit to the file's first launch here" in out


def test_registers_name_the_plain_soil_column_instances(tmp_path):
    """The ptxas report parser names the stage table's ``MODE_COLUMNS``
    instance ``rk:<mode>+kinds+B8`` and the implicit one ``<mode>+kinds+B8``;
    ``kernel_of`` names their kernels and sources."""
    rk = ck.MODE_COLUMNS | ck.MODE_LAGGED | ck.MODE_NO_ICE | ck.MODE_RHS_CAP
    imp = ck.MODE_COLUMNS | ck.MODE_BE_SOIL | ck.MODE_FREEZE_EQ
    report = {
        "rk_columns_kernel": f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rk_column_kernelIdLi{rk}"
                             "EEEv10KernelArgsdd' for 'sm_90a'\nptxas info    : Used 128 registers\n",
        "implicit_columns_kernel": "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122implicit_column_"
                                   f"kernelIfLi{imp}EEEv10KernelArgsff' for 'sm_90a'\nptxas info    : Used 96 "
                                   "registers\n"}
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report.get(name, ""))
    assert cs.registers(ck, libs) == {"f64, rk:B2-no-ice+kinds+B8": 128, "f32, B4-be-soil+B3-eq+kinds+B8": 96}
    assert cs.kernel_of(ck, rk & ~ck.MODE_RHS_CAP | ck.MODE_SSPRK104, F64) == (
        "rk_column_kernel", "landhydrology_tpu_torch/csrc/rk_columns_kernel.cu")
    assert cs.kernel_of(ck, imp | ck.MODE_PCR, F64) == (
        "implicit_column_kernel", "landhydrology_tpu_torch/csrc/implicit_columns_kernel.cu")
    assert cs.kernel_of(ck, ck.MODE_BE_SOIL | ck.MODE_LAGGED, F64)[1].endswith("implicit_policy_kernel.cu")


def test_later_build_runs_at_most_its_jobs_at_a_time(tmp_path, monkeypatch):
    """``build_library(sources, jobs)`` keeps at most ``jobs`` compiles
    running, started in the order of ``sources`` with f64 first (the
    background build's ``LATER_ORDER``, the longest first); each library is
    published and its seconds recorded.  A stand-in compiler logs its start
    and end."""
    log = tmp_path / "log"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/usr/bin/env python3\nimport sys, time\nlog = open(%r, 'a')\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\nlog.write(f'start {out} {time.time()}\\n'); log.flush()\n"
                    "time.sleep(0.3)\nopen(out, 'w').write('')\nlog.write(f'end {out} {time.time()}\\n')\n" % str(log))
    fake.chmod(0o755)
    monkeypatch.setattr(ck, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ck, "BUILD_SECONDS", {})
    popen, order = subprocess.Popen, []

    def started(cmd, *args, **kwargs):  # the order the build starts its compiles in (the children race to log)
        order.append(cmd[cmd.index("-o") + 1])
        return popen(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "Popen", started)
    sources = ("implicit_columns_kernel", "rk_columns_kernel", "implicit_policy_kernel")
    libs = ck.build_library(sources, jobs=2)
    assert list(libs) == [f"{s}_{t}" for s in sources for t in ("f64", "f32")]
    assert all(p.exists() for p in libs.values()) and set(ck.BUILD_SECONDS) == set(libs)
    events = [line.split() for line in log.read_text().splitlines()]
    running, most = 0, 0
    for kind, _, _ in sorted(events, key=lambda e: float(e[2])):
        running += 1 if kind == "start" else -1
        most = max(most, running)
    assert most == 2
    started_keys = [o.rsplit("/", 1)[1].rsplit("_", 1)[0] for o in order]
    assert started_keys == [f"{name}_{tag}" for name in sources for tag in ("f64", "f32")]
    assert sorted(cs.LATER_ORDER) == sorted(n for n in ck.SOURCES if n not in cs.FIRST_SOURCES)
