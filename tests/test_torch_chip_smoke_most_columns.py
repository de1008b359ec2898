"""Phase 21 of ``chip_smoke.py`` (per-column BC kinds and geometry under the
implicit steppers with a MOST top) without a GPU.

21c's cases hold each of the 24 new instances once (two again with PCR, a
third with forcing rows); ``most_columns_variant`` builds each with kinds at
its bottom faces and depths; 21c's checks and 21c's icy checks run with the
plain version as the kernel (``plain_card``) and accept it, and fail a
kernel that reads the model's uniform grid; 21a's paths form ice and equal
the script's own launch; 21b's run file names the instance; the records
carry every key of the kernels line.
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

F64, F32 = torch.float64, torch.float32
SOURCE = "implicit_most_columns_kernel"


def test_most_columns_cases_hold_every_new_instance():
    """The 24 instances of ``implicit_most_columns_kernel.cu`` once each with
    Thomas solves, eight with forcing rows (each stepper among them), two
    more with PCR; the new source builds first in the background (its
    compiles are among the longest, and last they ran alone)."""
    cases = cs.most_columns_cases()
    thomas = [(m, rows) for m, tri, rows in cases if tri == "thomas"]
    assert len(cases) == 26 and len({m for m, _ in thomas}) == 24
    assert {m.split("+")[0].split("-no-ice")[0] for m, rows in thomas if rows} == set(cs.IMPLICIT_STEPPERS)
    assert sum(rows for _, rows in thomas) == 8
    assert [m for m, tri, _ in cases if tri == "pcr"] == list(cs.MOST_COLUMNS_PCR)
    assert cs.LATER_ORDER[0] == SOURCE and SOURCE not in cs.FIRST_SOURCES


def test_assert_allclose_fails_shapes_that_broadcast():
    """``_assert_allclose`` fails a pair whose shapes differ but broadcast, as
    ``np.testing.assert_allclose`` does, and passes equal arrays."""
    with pytest.raises(AssertionError, match="shapes"):
        cs._assert_allclose(np.zeros((3, 1)), np.zeros((3, 4)), 1e-12, 1e-16, "broadcast")
    cs._assert_allclose(np.ones((3, 4)), np.ones((3, 4)), 1e-12, 1e-16, "equal")


@pytest.mark.parametrize("mode,tridiag,rows", cs.most_columns_cases(), ids=lambda c: str(c))
def test_most_columns_variant_builds_its_instance(mode, tridiag, rows):
    """Each case builds its mode with kinds at the bottom faces (the MOST
    top's stay the exchange's) and depths from the new source, with rows
    where the case has them; the run name carries ``-pcr`` where
    ``mode_name`` puts it."""
    model, Y, st, dt, steps = cs.most_columns_variant(12, F64, "cpu", mode, tridiag)
    fields = tuple(cs.policy_rows(model, steps, seed=37)) if rows else ()
    run = ck.make_fused_column_run(model, st, dt=dt, forcing_fields=fields)
    name = (cs.pcr_name(mode) if tridiag == "pcr" else mode) + "+kinds+B8" + ("+B7" if rows else "")
    assert run.name == name and ck._entry(run.mode, F64)[0] == SOURCE
    assert isinstance(model.domain, VariableDepthColumn) and (dt, steps) == (cs.IMPLICIT_DT, cs.IMPLICIT_STEPS)
    bottom = model.boundary_conditions.bottom
    assert isinstance(bottom.hydrology, BatchedBC) and isinstance(bottom.energy, BatchedBC)
    assert set(bottom.hydrology.kind.tolist()) <= {0, 1, 2} and float(Y["soil"]["theta_i"].max()) >= 0.02


def test_most_columns_checks_pass_the_plain_version(plain_card, monkeypatch, capsys):  # noqa: F811
    """21c and 21d over a shortened list: the plain version standing in for
    the kernel passes the checks; 21d's records (all but the PCR repeat's)
    carry every key of the kernels line and name the instance with
    ``+kinds+B8`` (and ``+B7``)."""
    monkeypatch.setattr(cs, "COLD_NCOL", 24)
    monkeypatch.setattr(cs, "NCOL", 32)
    monkeypatch.setattr(cs, "COLD_PROBE_STRIDE", 8)
    cases = [("B4-trbdf2+B3-rate+B5", "thomas", True), ("B4-be-soil-no-ice+B2+B5", "thomas", False),
             ("B4-be-richards-no-ice+B5", "pcr", False)]
    monkeypatch.setattr(cs, "most_columns_cases", lambda: cases)
    checked = cs.most_columns_checks(ck, F64, "cpu")
    assert [c[3] for c in checked] == ["B4-trbdf2+B3-rate+B5+kinds+B8+B7", "B4-be-soil-no-ice+B2+B5+kinds+B8",
                                       "B4-be-richards-no-ice-pcr+B5+kinds+B8"]
    records = cs.most_columns_times(ck, COSTS, "smi", F64, "cpu", checked)
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == [
        "B4-trbdf2+B3-rate+B5+kinds+B8+B7", "B4-be-soil-no-ice+B2+B5+kinds+B8"]
    for r in records:
        assert set(r) - {"plain_at"} == KEYS and r["max_abs_err"] == 0.0 and r["bound_ms"] > 0.0
        assert r["source"] == f"landhydrology_tpu_torch/csrc/{SOURCE}.cu"
    out = capsys.readouterr().out
    assert "B4-be-richards-no-ice-pcr+B5+kinds+B8 0.00e+00" in out and "ice grew in" in out


def test_most_columns_check_fails_a_kernel_on_the_uniform_grid(plain_card, monkeypatch):  # noqa: F811
    """A "kernel" that steps the model on one uniform depth (without the
    per-column depths) fails 21c's check."""
    monkeypatch.setattr(cs, "COLD_NCOL", 24)
    monkeypatch.setattr(cs, "most_columns_cases", lambda: [("B4-trbdf2+B5", "thomas", False)])
    call = ck.FusedColumnRun.__call__

    def uniform(self, Y, t0, forcing=None, dt_run=None):
        from landhydrology_tpu_torch import Column

        soil = self.model
        self.model = dataclasses.replace(soil, domain=Column(zlim=(-2.0, 0.0), nelements=soil.domain.nelements,
                                                             batch_shape=soil.domain.batch_shape))
        return call(self, Y, t0, forcing=forcing, dt_run=dt_run)

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", uniform)
    with pytest.raises(AssertionError):
        cs.most_columns_checks(ck, F64, "cpu")


def test_icy_columns_checks_hold_the_cap(plain_card, monkeypatch, capsys):  # noqa: F811
    """21c's icy checks over one mode per source: the start state has cells
    past nu - theta_i, the step is well conditioned, and the plain version
    as the kernel passes; a "kernel" that steps the model with its ice
    (``assume_no_ice`` off: neither the no-ice closures nor their cap) fails."""
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    monkeypatch.setattr(cs, "SOIL_COLUMNS_NCOL", 48)
    monkeypatch.setattr(cs, "ICY_COLUMNS_MODES", ("B4-be-soil-no-ice+B2",))
    out = cs.icy_columns_checks(ck, "cpu")
    assert set(out) == {"B4-be-soil-no-ice+B2+kinds+B8", "B4-be-soil-no-ice+B2+B5+kinds+B8"}
    assert all(err == 0.0 for err, _ in out.values())
    assert "one ulp of the start moves the plain version" in capsys.readouterr().out
    call = ck.FusedColumnRun.__call__

    def capped_at_nu(self, Y, t0, forcing=None, dt_run=None):
        soil = self.model
        self.model = dataclasses.replace(soil, assume_no_ice=False)  # the ice's own closures: no cap at all
        return call(self, Y, t0, forcing=forcing, dt_run=dt_run)

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", capped_at_nu)
    with pytest.raises(AssertionError):
        cs.icy_columns_checks(ck, "cpu")


@pytest.mark.parametrize("name,dtype", [("B4-trbdf2+B3-rate+B5", F64), ("B4-trbdf2+B2+B3-eq+B5", F32)],
                         ids=["rows-f64", "eq-f32"])
def test_most_columns_paths_form_ice(plain_card, monkeypatch, capsys, name, dtype):  # noqa: F811
    """21a on 32 columns over 4 steps with the plain version as the kernel:
    the rows path through ``make_forced_segment_run``, the other through
    ``Simulation``; each equal to the script's own launch, ice formed, its
    record timed from the start state beside 17d's instance."""
    monkeypatch.setattr(cs, "NCOL", 32)
    monkeypatch.setattr(cs, "COLD_IMPLICIT_STEPS", 4)
    monkeypatch.setattr(cs, "COLD_PROBE_STRIDE", 8)
    record = cs.most_columns_path(ck, COSTS, "smi", dtype, "cpu", name)
    out = capsys.readouterr().out
    assert "equal bit for bit to the script's own launch" in out and "ice formed" in out
    rows = "+B7" if name == cs.MOST_COLUMNS_ROWS_PATH else ""
    assert f"17d's {name}{rows} on the same state" in out and "MODE_COLUMNS under MOST costs" in out
    assert set(record) - {"plain_at"} == KEYS and record["launches"] == 1
    assert record["name"] == f"implicit_column_kernel<{str(dtype)[6:].replace('float', 'f')}, {name}+kinds+B8{rows}>"


def test_flagship_cli_runs_its_instance(plain_card, monkeypatch, tmp_path, capsys):  # noqa: F811
    """21b on 96 columns, launches of 4 steps, with the CLI run in process:
    the run file's soil is the flagship's on a variable depth with a batched
    bottom, launches ``B4-trbdf2+B5+kinds+B8``, its first save the file's
    first launch."""
    from landhydrology_tpu_torch import cli

    monkeypatch.setattr(cs, "FLAGSHIP_NCOL", 96)
    monkeypatch.setattr(cs, "FLAGSHIP_SPC", 4)
    monkeypatch.setattr(cs, "FLAGSHIP_STRIDE", 8)

    def run_cli(path, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["run", path, "--device", "cpu"]) == 0
        out = buf.getvalue()
        launches = json.loads(out.split("kernel launches: ", 1)[1].splitlines()[0])
        return out, launches, float(re.search(r"cells in ([0-9.e+-]+) s \(host clock\)", out).group(1))

    monkeypatch.setattr(cs, "_start_cli", lambda path: path)  # the CLI runs in process when 21b collects it
    monkeypatch.setattr(cs, "_finish_cli", run_cli)
    record = cs.flagship_cli(ck, COSTS, "smi", "cpu", str(tmp_path))
    assert record["name"] == "implicit_column_kernel<f64, B4-trbdf2+B5+kinds+B8>"
    assert set(record) - {"plain_at"} == KEYS and record["launches"] == cs.FLAGSHIP_LAUNCHES
    assert "its first save equal bit for bit" in capsys.readouterr().out
    cfg = json.load(open(tmp_path / "flagship_soil.json"))
    assert cfg["simulation"]["stepper"] == "TRBDF2Soil" and cfg["simulation"]["iters"] == 2
    soil = cs.flagship_soil("cpu", 12)
    assert soil.domain.nelements == 24 and isinstance(soil.boundary_conditions.bottom.hydrology, BatchedBC)


def test_registers_and_kernel_of_name_the_new_instances(tmp_path):
    """The ptxas report parser names a new instance ``<mode>+B5+kinds+B8``;
    ``kernel_of`` names its kernel and source."""
    mode = ck.MODE_COLUMNS | ck.MODE_MOST | ck.MODE_TRBDF2 | ck.MODE_FREEZE_RATE
    report = (f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122implicit_column_kernelIdLi{mode}"
              "EEEv10KernelArgsdd' for 'sm_90a'\nptxas info    : Used 255 registers\n")
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == SOURCE else "")
    assert cs.registers(ck, libs) == {"f64, B4-trbdf2+B3-rate+B5+kinds+B8": 255}
    assert cs.kernel_of(ck, mode | ck.MODE_PCR, F32) == (
        "implicit_column_kernel", f"landhydrology_tpu_torch/csrc/{SOURCE}.cu")


def test_compare_with_builds_the_parent_before_any_timed_run(monkeypatch, capsys):
    """``--compare-with``: the parent's kernels build in a subprocess of their
    own before the timed runs (parent, this, this, parent); the parent's
    registers are held, and a kernel time off the parent's by more than 2%
    fails."""
    calls = []

    def run(cmd, cwd, **kwargs):
        code = cmd[-1]
        calls.append((cwd, "build" if "build_library()" in code and "COMPARE" not in code else "timed"))
        ms = {"float64 B6-pond-water": [20.0] * 4} if cwd == "parent" else {"float64 B6-pond-water": [20.2] * 4}
        out = {"registers": {"f64, B6-pond-water": 148}, "spills": {}, "ms": ms}
        return subprocess.CompletedProcess(cmd, 0, "COMPARE " + json.dumps(out), "")

    monkeypatch.setattr(subprocess, "run", run)
    cs.compare_with("parent", "smi")
    assert calls == [("parent", "build"), ("parent", "timed"), (cs.HERE, "timed"), (cs.HERE, "timed"),
                     ("parent", "timed")]
    assert "median ratio 1.0100 (bar 1 +- 0.02)" in capsys.readouterr().out

    def slow(cmd, cwd, **kwargs):
        out = run(cmd, cwd)
        if cwd == cs.HERE:
            out.stdout = out.stdout.replace("20.2", "20.6")
        return out

    monkeypatch.setattr(subprocess, "run", slow)
    with pytest.raises(AssertionError, match="off the parent's by more than 2%"):
        cs.compare_with("parent", "smi")
