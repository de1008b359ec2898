"""Phase 18 of ``chip_smoke.py`` (the explicit steppers under a MOST top and
a LandModel, the LandModel run files, the implicit steppers' policies on
the water-only branch) without a GPU.

18c's cases give each new stepper every flag of the land body; its check
runs with the plain version as the kernel (``plain_card``) and accepts it,
and fails a kernel that steps the pond with SSPRK33's weights under
SSPRK104 or skips SSPRK104's split stage; 18d's checks and 18c's records
carry every key of the kernels line; 18a's lagged stiff path stays within
bench.py's max_dev_lagged bar of the stage run; 18b's run files go through
the CLI and equal a straight ``Simulation`` bit for bit; the bound counts
one surface exchange and one pond tendency per stage of the stepper.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import contextlib
import io
import json
import re
import threading

import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu_torch import timestepping as pts
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_chip_smoke import plain_card  # noqa: F401
from tests.test_torch_chip_smoke_land import COSTS, KEYS

F64 = torch.float64


def test_land_rk_cases_give_each_stepper_every_flag():
    """The 48 land instances without ``MODE_COLUMNS``, once each; each new
    stepper meets lagged coefficients, rate and equilibrium freeze-thaw, no
    ice, the frozen exchange, MOST and plain tops and the water-only
    LandModel, with rows and without; a third carry rows."""
    cases = cs.land_rk_cases()
    assert len(cases) == len({n for n, _, _ in cases}) == 48
    flags = {st: set() for st in cs.RK_STEPPERS}
    for name, stepper, rows in cases:
        for flag, on in (("lagged", name.startswith("B2+")), ("rate", "+B3-rate" in name), ("eq", "+B3-eq" in name),
                         ("no ice", "-no-ice" in name), ("frozen", "-step" in name), ("plain top", "-pond" in name),
                         ("MOST", "-pond" not in name), ("water", "-water" in name), ("rows", rows),
                         ("no rows", not rows)):
            if on:
                flags[stepper].add(flag)
    assert all(len(f) == 10 for f in flags.values()), flags
    assert sum(rows for _, _, rows in cases) == 16
    names = {ck.make_fused_column_run(cs.policy_variant(n, F64, "cpu")[0], pts.SSPRK22()).name for n, _, _ in cases[:3]}
    assert names == {"B5@SSPRK22", "B2+B5@SSPRK22", "B6@SSPRK22"}


def test_bound_counts_an_exchange_and_a_pond_tendency_per_stage():
    """Under a new stepper the surface modes solve MOST once per stage (once
    per step with the frozen exchange), and the pond takes its tendency per
    stage and the stepper's stage combinations."""
    land, most = ck.MODE_LAND | ck.MODE_MOST, ck.MODE_MOST
    assert [cs.most_exchanges(ck, most | m) for m in (ck.MODE_EULER, ck.MODE_SSPRK22, 0, ck.MODE_SSPRK104)] == [1, 2, 3, 10]
    assert cs.most_exchanges(ck, land | ck.MODE_SURFACE_STEP | ck.MODE_SSPRK104) == 1
    pond = {m: cs.column_step_ops(ck, ck.MODE_LAND | m, F64)["op"] for m in (0, ck.MODE_EULER, ck.MODE_SSPRK104)}
    exchange = cs.column_step_ops(ck, ck.MODE_LAND | ck.MODE_EULER, F64)["op"] - (2 + 1)
    assert pond[0] == 3 * exchange + 3 * 2 + 6 and pond[ck.MODE_SSPRK104] == 10 * exchange + 10 * 2 + 16
    assert cs.stage_combinations(ck, ck.MODE_SSPRK22) == 4 and cs.explicit_stages(ck, ck.MODE_SSPRK104) == 10


@pytest.mark.parametrize("name,stepper,rows", [("B6-step+B3-eq", "ForwardEuler", True),
                                               ("B2+B5+B3-rate", "SSPRK22", False),
                                               ("B6-pond-water", "SSPRK104", True)])
def test_land_rk_check_passes_the_plain_version(plain_card, monkeypatch, name, stepper, rows):  # noqa: F811
    monkeypatch.setattr(cs, "COLD_NCOL", 48)
    err, shares, grown, melted, plain_ms, probes = cs.cold_check(ck, name, F64, "cpu", rows=rows, tag="18c",
                                                                 stepper=stepper)
    assert err == 0.0 and "vartheta_l" in shares and plain_ms > 0.0
    assert (grown > 0 and melted > 0) if "B3" in name else grown == melted == 0
    assert (probes is None) == ("-pond" in name)


class NoSplit(pts.SSPRK104):
    """SSPRK104 without its split stage: ten stages of dt/6 on q1."""

    def step(self, rhs, Y, Ya, t, dt):
        q1 = Y
        for tq in self.stage_times(t, dt):
            q1 = pts._axpy(dt / 6.0, rhs(q1, Ya, tq), q1)
        return q1


@pytest.mark.parametrize("fault", ["pond_with_ssprk33_weights", "no_split_stage"])
def test_land_rk_check_fails_a_wrong_kernel(plain_card, monkeypatch, fault):  # noqa: F811
    """A "kernel" whose pond follows SSPRK33's stage weights under SSPRK104
    (its soil right), or that skips SSPRK104's split stage, fails 18c's
    check."""
    monkeypatch.setattr(cs, "COLD_NCOL", 48)

    def wrong(self, Y, t0, forcing=None, dt_run=None):
        if fault == "no_split_stage":
            out = ck.fused_column_run_plain(self.model, NoSplit(), self.dt, self.steps_per_call, Y, t0)
        else:
            out = ck.fused_column_run_plain(self.model, self.stepper, self.dt, self.steps_per_call, Y, t0)
            pond = ck.fused_column_run_plain(self.model, pts.SSPRK33(), self.dt, self.steps_per_call, Y, t0)
            out["surface"] = pond["surface"]
        for group in out:
            for k, v in Y[group].items():
                v.copy_(out[group][k])
        ck.LAUNCHES[self.name] += 1
        return Y

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", wrong)
    with pytest.raises(AssertionError, match="h_s" if fault.startswith("pond") else "vartheta_l"):
        cs.cold_check(ck, "B6", F64, "cpu", tag="18c", stepper="SSPRK104")


def test_land_rk_and_water_policy_records(plain_card, monkeypatch, capsys):  # noqa: F811
    """18c over a shortened list and 18d: the records carry every key of the
    kernels line, their names the instance and its stepper, their plain time
    the check's launch, their kernel time a launch at width (here the
    narrowed ``NZ`` x ``NCOL`` and ``STORM_SIDE``); 18d names the six
    water-branch instances and PCR on two."""
    for name, value in (("COLD_NCOL", 24), ("NZ", 8), ("NCOL", 32), ("STORM_SIDE", 4), ("COLD_PROBE_STRIDE", 8),
                        ("LAND_RK_MODES", ("B2+B6-step", "B5+B3-eq", "B6-pond-water-no-ice"))):
        monkeypatch.setattr(cs, name, value)
    records = cs.land_rk_checks(ck, COSTS, "smi", F64, "cpu")
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == [
        "B2+B6-step+B7@ForwardEuler", "B5+B3-eq@SSPRK22", "B6-pond-water-no-ice@SSPRK104"]
    water = cs.water_policy_checks(ck, COSTS, "smi", F64, "cpu")
    assert [r["name"].split(", ", 1)[1][:-1] for r in water] == [
        "B4-trbdf2-water+B2", "B4-trbdf2-water-no-ice", "B4-trbdf2-water-no-ice+B2", "B4-be-richards-water+B2",
        "B4-be-richards-water-no-ice", "B4-be-richards-water-no-ice+B2", "B4-trbdf2-water-pcr+B2",
        "B4-be-richards-water-no-ice-pcr+B2"]
    for r in records + water:
        assert set(r) - {"plain_at"} == KEYS and r["max_abs_err"] == 0.0 and r["plain_ms"] > 0.0
        assert r["source"].startswith("landhydrology_tpu_torch/csrc/") and r["bound_ms"] > 0.0
    assert all(r["source"].endswith("implicit_branch_kernel.cu") for r in water)
    timed = [line for line in capsys.readouterr().out.splitlines() if " time] float64 " in line]
    assert len(timed) == 3 + 8 and all(f" {cs.RK_TIMED_STEPS} steps " in line for line in timed)
    assert all(("ncol=16" if "-water-no-ice@" in line else "nz=8 ncol=32") in line for line in timed)


def test_lagged_stiff_path_within_the_lagged_bar(plain_card, monkeypatch):  # noqa: F811
    """18a on a narrow stiff column: one launch of lagged TR-BDF2 at
    ``STIFF_LAGGED_FACTOR`` dt_exp, checked against the plain version, within
    bench.py's max_dev_lagged bar of the stage run and in range."""
    monkeypatch.setattr(cs, "NCOL", 16)
    paths = cs.lagged_stiff_paths(ck, "cpu")
    assert [ck.make_fused_column_run(m, st).name for m, _, _, _, _, _, st in paths] == ["B4-trbdf2-water+B2"] * 2
    assert all(launches == 1 and spc == cs.STIFF_STEPS for _, _, _, spc, launches, _, _ in paths)


def test_land_run_files_through_the_cli(plain_card, monkeypatch, capsys, tmp_path):  # noqa: F811
    """18b on a narrow grid, the CLI in this process on the CPU: each
    setting's run file runs SSPRK104 on the fused engine, its saves equal a
    straight ``Simulation`` bit for bit and its first launch the plain
    version; the records name the two settings under SSPRK104 and B6 under
    the other steppers."""
    from landhydrology_tpu_torch import cli

    def run_cli(path, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.cmd_run(path, device="cpu") == 0
        text = buf.getvalue()
        launches = json.loads(text.split("kernel launches: ", 1)[1].splitlines()[0])
        return text, launches, float(re.search(r"cells in ([0-9.e+-]+) s \(host clock\)", text).group(1))

    # the CLIs run in process, in CliRuns' thread, when 18b collects them
    for name, value in (("_start_cli", lambda path: path), ("_finish_cli", run_cli), ("NZ", 8), ("NCOL", 16),
                        ("SPC", 2), ("CLI_SAMPLE", 4), ("COLD_PROBE_STRIDE", 4), ("COLD_TIMED_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    records = cs.land_cli_phase(ck, COSTS, "smi", "cpu", str(tmp_path))
    names = [r["name"].split(", ", 1)[1][:-1] for r in records]
    assert names == ["B6@SSPRK104", "B2+B6-step@SSPRK104", "B6@SSPRK104", "B6@ForwardEuler", "B6@SSPRK22",
                     "B2+B6-step@SSPRK104", "B6@ForwardEuler", "B6@SSPRK22"]
    assert all(set(r) - {"plain_at"} == KEYS and r["max_abs_err"] == 0.0 for r in records)
    assert records[0]["launches"] == cs.CLI_LAUNCHES
    assert "the CLI's bit for bit" in capsys.readouterr().out


def _in_process_cli():
    """A stand-in for ``_finish_cli`` that runs the CLI in this process on
    the CPU, one run at a time (``CliRuns``' threads share stdout here)."""
    from landhydrology_tpu_torch import cli

    lock = threading.Lock()

    def run_cli(path, what):
        buf = io.StringIO()
        with lock, contextlib.redirect_stdout(buf):
            assert cli.cmd_run(path, device="cpu") == 0
        text = buf.getvalue()
        launches = json.loads(text.split("kernel launches: ", 1)[1].splitlines()[0])
        return text, launches, float(re.search(r"cells in ([0-9.e+-]+) s \(host clock\)", text).group(1))

    return run_cli


def test_run_file_clis_run_ahead_and_are_checked_later(plain_card, monkeypatch, capsys):  # noqa: F811
    """``main``'s order on a narrow grid: 15b's and 18b's run files written
    (``CliAhead``), 15b's times, the CLIs started and run (in this process)
    while other work goes on, then checked: 15b's B resumes from A's
    checkpoint and equals the straight run, 18b's saves equal a straight
    ``Simulation``; 18b's times follow.  The records are 15b's and 18b's."""
    for name, value in (("_start_cli", lambda path: path), ("_finish_cli", _in_process_cli()), ("NZ", 8),
                        ("NCOL", 16), ("SPC", 2), ("CLI_SAMPLE", 4), ("COLD_PROBE_STRIDE", 4),
                        ("COLD_TIMED_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    ahead = cs.CliAhead("cpu", 0)
    records, ahead.kernel_ms = cs.cli_times(ck, COSTS, "smi", "cpu", 0, ahead.spec)
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == [
        f"B1@{n}" for n in cs.RK_STEPPERS] * 2 and records[-1]["launches"] == cs.CLI_LAUNCHES
    ahead.start()
    cs._quiet()  # in this process the runs share the launch counts (on the card they are subprocesses)
    records = ahead.check(ck, COSTS, "smi", "cpu")
    assert [r["name"].split(", ", 1)[1][:-1] for r in records] == ["B6@SSPRK104", "B2+B6-step@SSPRK104"]
    assert not any(runs.is_alive() for runs in cs._BACKGROUND)
    records = cs.land_cli_times(ck, COSTS, "smi", "cpu", ahead.land_dts)
    assert all(set(r) - {"plain_at"} == KEYS for r in records) and len(records) == 6
    out = capsys.readouterr().out
    assert "resumed run = straight run bit for bit" in out and "the CLI's run A:" in out
    assert out.count("the CLI's bit for bit") == 2


def test_cli_runs_keep_their_order_and_raise_the_first_failure(monkeypatch):
    """``CliRuns`` returns its runs' results in the order of its paths, in
    turn or together, and raises the first failure from ``results``."""
    monkeypatch.setattr(cs, "_start_cli", lambda path: path)
    monkeypatch.setattr(cs, "_finish_cli", lambda path, what: (path, what, 0.0))
    assert cs.CliRuns(["a", "b"], "x").results() == [("a", "x", 0.0), ("b", "x", 0.0)]
    assert cs.CliRuns(["c", "d"], "y", together=True).results() == [("c", "y", 0.0), ("d", "y", 0.0)]

    def fail(path, what):
        raise AssertionError(f"{what}: the CLI exited 1")

    monkeypatch.setattr(cs, "_finish_cli", fail)
    with pytest.raises(AssertionError, match="z: the CLI exited 1"):
        cs.CliRuns(["e"], "z").results()


def test_registers_name_the_stage_table_instances(tmp_path):
    """The ptxas report parser tells a land mode's stage-table instance
    (``table:``) from its SSPRK33 twin by the kernel's bool template
    argument."""
    mode = ck.MODE_LAND | ck.MODE_MOST
    report = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118land_column_kernelIdLi{mode}ELb{b}EEEv10Kernel"
        f"Argsdd' for 'sm_90a'\nptxas info    : Used {r} registers, used 0 barriers\n" for b, r in ((0, 202), (1, 254)))
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == "land_kernel" else "")
    assert cs.registers(ck, libs) == {"f64, B6": 202, "f64, table:B6": 254}
    assert cs.kernel_of(ck, mode | ck.MODE_SSPRK22, F64) == (
        "land_column_kernel", "landhydrology_tpu_torch/csrc/land_rk_kernel.cu")
