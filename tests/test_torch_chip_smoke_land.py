"""Phase 16 of ``chip_smoke.py`` (the cold land path) without a GPU.

The builders make the 30 modes of ``csrc/land_policy_kernel.cu`` they name,
on a cold state (16a: 268-278 K with ice, theta_atm within 8 K of the top;
16b/16c: ``bench.py::build_land``'s LandModel around the cold freeze column
under a 263.15 K atmosphere); the checks run with the plain version as the
kernel (``plain_card``) and accept it, count the columns where ice grew and
melted, and fail a kernel that drops the phase change; 16b's path forms ice
and closes its water budget on a narrow width; 16c's record carries every
key of the kernels line.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from landhydrology_tpu_torch.constants import default_earth_param_set as ps
from landhydrology_tpu_torch.models.land import LandModel, _diagnose_state_T
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_chip_smoke import plain_card  # noqa: F401

F64 = torch.float64
#: the bound's instruction costs of exp, log, sqrt, a division and pow (any numbers: not measured here)
COSTS = {d: {"exp": 20, "log": 20, "sqrt": 10, "div": 10, "pow": 40} for d in (torch.float32, torch.float64)}
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms"}


def test_cold_modes_are_the_thirty_policy_instances():
    """``COLD_MODES`` names the 30 modes of the policy source once each; the
    variant builder makes each (cold or not), the paths are among them."""
    assert len(cs.COLD_MODES) == len(set(cs.COLD_MODES)) == 30
    assert set(cs.COLD_PATHS) <= set(cs.COLD_MODES)
    for name in cs.COLD_MODES:
        model, Y = cs.build_land_variant(8, F64, "cpu", seed=29, case=name, cold=True)
        mode = ck.kernel_mode(model)
        assert ck.mode_name(mode) == name and ck._entry(mode, F64)[0] == "land_policy_kernel"
        assert ("surface" in Y) == isinstance(model, LandModel)
    assert cs.cold_policy("B6-step") == ("B6-step", {})


def test_cold_variant_freezes_some_columns_and_thaws_others():
    """16a's column: 268-278.5 K by column with 0.02 of ice everywhere and
    theta_atm within 8 K of the top cell; the variant without ``cold`` is
    the one phase 10 draws, unchanged."""
    model, Y = cs.build_land_variant(64, F64, "cpu", seed=29, case="B6+B3-rate", cold=True)
    soil = model.soil
    T = _diagnose_state_T(soil, Y["soil"], {})
    assert 268.0 <= float(T.min()) < ps.T_0 < float(T.max()) <= 278.5
    assert torch.all(Y["soil"]["theta_i"] == 0.02)
    d = soil.boundary_conditions.top.theta_atm - T[-1]
    assert float(d.abs().max()) <= 8.0 and float(d.min()) < 0.0 < float(d.max())
    warm, Yw = cs.build_land_variant(64, F64, "cpu", seed=13, case="B6")
    again, Ya = cs.build_land_variant(64, F64, "cpu", seed=13, case="B6+B3-rate")
    assert torch.equal(Yw["soil"]["rho_e_int"], Ya["soil"]["rho_e_int"])
    assert torch.equal(warm.soil.boundary_conditions.top.theta_atm, again.soil.boundary_conditions.top.theta_atm)
    assert again.soil.freeze_thaw is not None and warm.soil.freeze_thaw is None


@pytest.mark.parametrize("case", ["B5+B3-eq", "B2+B6-step+B3-rate", "B6-pond-no-ice"])
def test_cold_land_builder(case):
    """16b/16c's model: the freeze column's soil (nz=64) with the policy,
    under bench.py's atmosphere at 263.15 K (B5 alone, B6 in a LandModel
    with bench.py's rain and pond) or, for ``-pond``, its own -10 C top."""
    model, Y, Ya, dt = cs.build_cold_land(cs._load_golden_config(), F64, "cpu", case, ncol=16)
    assert ck.mode_name(ck.kernel_mode(model)) == case and dt == cs.FREEZE_DT
    soil = getattr(model, "soil", model)
    assert soil.domain.nelements == cs.NZ and Y["soil"]["vartheta_l"].shape == (cs.NZ, 16)
    top = soil.boundary_conditions.top
    if case.startswith("B5") or "-pond" not in case:
        assert top.theta_atm == cs.COLD_THETA_ATM and top.u_atm == 2.0
    else:
        assert float(top.energy.state_value(0.0)) == 263.15
    if isinstance(model, LandModel):
        assert torch.all(Y["surface"]["h_s"] == 1e-4) and model.surface.tau_pond == 300.0
    T = _diagnose_state_T(soil, Y["soil"], {})
    assert 273.4 - 1e-9 <= float(T.min()) and float(T.max()) <= 275.4 + 1e-9


def test_cold_check_passes_the_plain_version_and_counts_ice(plain_card, monkeypatch):  # noqa: F811
    """16a's check with the plain version as the kernel: error 0, ice grew
    in some columns and melted in others under freeze-thaw; a no-ice
    instance leaves theta_i alone, on the icy state too."""
    monkeypatch.setattr(cs, "COLD_NCOL", 64)
    err, shares, grown, melted, _, _ = cs.cold_check(ck, "B2+B6-step+B3-rate", F64, "cpu")
    assert err == 0.0 and grown > 0 and melted > 0 and set(shares) == {"vartheta_l", "rho_e_int"}
    err, _, grown, melted, _, _ = cs.cold_check(ck, "B5-no-ice", F64, "cpu", icy=True)
    assert err == 0.0 and grown == melted == 0


def test_cold_check_fails_a_kernel_that_drops_the_phase_change(plain_card, monkeypatch):  # noqa: F811
    """A "kernel" that steps the model without its freeze-thaw scheme fails
    16a's check."""
    monkeypatch.setattr(cs, "COLD_NCOL", 64)
    call = plain_card

    def no_phase_change(self, Y, t0, forcing=None, dt_run=None):
        model = dataclasses.replace(self.model, soil=dataclasses.replace(self.model.soil, freeze_thaw=None))
        out = call(ck.FusedColumnRun(model, self.stepper, self.dt, self.steps_per_call, self.tile_cols), Y, t0)
        ck.LAUNCHES[self.name] += 1
        return out

    monkeypatch.setattr(ck.FusedColumnRun, "__call__", no_phase_change)
    with pytest.raises(AssertionError):
        cs.cold_check(ck, "B6+B3-rate", F64, "cpu")


def test_cold_path_forms_ice_and_closes_the_water_budget(plain_card, monkeypatch, capsys):  # noqa: F811
    """16b on 16 columns with the plain version as the kernel: ice forms,
    the budget closes, the record carries every key (and, the production
    path held by a shorter launch since phase 19, its check's ``plain_at``),
    the launch is counted and the MOST probes come from the sampled
    columns."""
    monkeypatch.setattr(cs, "NCOL", 16)
    monkeypatch.setattr(cs, "COLD_PROBE_STRIDE", 4)
    record = cs.cold_path(ck, cs._load_golden_config(), COSTS, "smi", F64, "cpu", "B2+B6-step+B3-rate")
    assert set(record) - {"plain_at"} == KEYS and record["launches"] == 1 and record["max_abs_err"] == 0.0
    assert record["plain_at"] == f"the path's check: nz={cs.NZ} x 16, {cs.COLD_TIMED_STEPS} steps"
    assert record["name"] == "land_column_kernel<f64, B2+B6-step+B3-rate>"
    assert record["source"] == "landhydrology_tpu_torch/csrc/land_policy_kernel.cu"
    out = capsys.readouterr().out
    assert "ice formed" in out and "water budget" in out and "host share" in out


def test_time_cold_record(plain_card, monkeypatch):  # noqa: F811
    """16c: a MOST instance at a narrow width, kernel only; the record
    carries every key, 16a's error and plain time (``plain_at``) and a
    bound counted with the MOST probes, which it returns beside it."""
    monkeypatch.setattr(cs, "NCOL", 32)
    monkeypatch.setattr(cs, "COLD_PROBE_STRIDE", 8)
    record, probes = cs.time_cold(ck, cs._load_golden_config(), COSTS, "smi", F64, "cpu", "B5-no-ice", (1.5e-9, 7.0))
    assert probes > 1.0
    assert set(record) - {"plain_at"} == KEYS and record["plain_ms"] == 7.0 and record["max_abs_err"] == 1.5e-9
    assert record["bound_by"] in ("bytes", "operations") and np.isfinite(record["bound_ms"])
    most = cs.bound_ms(ck, COSTS, ck.kernel_mode(cs.build_cold_land(cs._load_golden_config(), F64, "cpu", "B5-no-ice",
                                                                     ncol=32)[0]),
                       F64, cs.NZ * 32, cs.COLD_TIMED_STEPS, ncol=32, probes=100.0)[0]
    assert most > cs.bound_ms(ck, COSTS, ck.MODE_NO_ICE, F64, cs.NZ * 32, cs.COLD_TIMED_STEPS)[0]


def test_freeze_bars_after_several_projections():
    """After n projections a few cells (at most ``FREEZE_CARRIED_CELLS`` on
    a small field) may pass one projection's allowance by up to n times it;
    more cells, a cell past n times it, or any cell past it after one
    projection fail."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    rate, Y, _, _ = cs._load_golden_config().build_freeze_model_and_state(F64, "cpu")
    eq = dataclasses.replace(rate, freeze_thaw=EquilibriumFreezeThaw())
    plain = cs._np(Y)
    water, _ = cs._check_freeze(plain, plain, eq, F64, "eq")

    def off(cells, times):
        theta = plain["theta_i"].copy()
        theta.reshape(-1)[:cells] += times * water
        return dict(plain, theta_i=theta)

    cs._check_freeze(off(3, 7.0), plain, eq, F64, "eq", projections=32)
    with pytest.raises(AssertionError, match="theta_i"):
        cs._check_freeze(off(3, 7.0), plain, eq, F64, "eq")
    with pytest.raises(AssertionError, match="cells past one projection"):
        cs._check_freeze(off(cs.FREEZE_CARRIED_CELLS + 1, 2.0), plain, eq, F64, "eq", projections=32)
    with pytest.raises(AssertionError, match="cells past one projection"):
        cs._check_freeze(off(1, 40.0), plain, eq, F64, "eq", projections=32)
    cs._check_freeze(plain, plain, rate, F64, "rate", projections=32)


def test_registers_and_spill_stores_of_the_policy_instances(tmp_path):
    """The ptxas report parser names a policy instance (MODE_RHS_CAP
    stripped) and reads its registers and its own spill stores, not a
    device function's."""
    mode = ck.MODE_LAND | ck.MODE_MOST | ck.MODE_NO_ICE | ck.MODE_RHS_CAP
    entry = f"_ZN12_GLOBAL__N_118land_column_kernelIdLi{mode}EEEv10KernelArgsdd"
    report = (
        f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118surface_conditionsIdEEv\n"
        "    40 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
        f"ptxas info    : Function properties for {entry}\n"
        "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 0 barriers\n"
    )
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == "land_policy_kernel" else "")
    assert cs.registers(ck, libs) == {"f64, B6-no-ice": 255}
    assert cs.spill_stores(ck, libs) == {"f64, B6-no-ice": 8}
    assert cs.kernel_of(ck, mode & ~ck.MODE_RHS_CAP, torch.float64) == (
        "land_column_kernel", "landhydrology_tpu_torch/csrc/land_policy_kernel.cu")


def test_pond_after_several_equilibrium_projections_is_held_by_its_change(capsys):
    """The pond of an equilibrium path checked after several projections
    is left to ``_check_increment`` (and printed); after one, or under the
    rate scheme, it keeps ``_check``'s bar."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    rate, Y, _, _ = cs._load_golden_config().build_freeze_model_and_state(F64, "cpu")
    eq = dataclasses.replace(rate, freeze_thaw=EquilibriumFreezeThaw())
    plain = dict(cs._np(Y), h_s=np.full(4, 1e-4))
    off = dict(plain, h_s=plain["h_s"] * (1 + 1e-10))
    cs._check_freeze(off, plain, eq, F64, "eq", projections=32)
    assert "held to its change" in capsys.readouterr().out
    for model, projections in ((eq, 1), (rate, 32)):
        with pytest.raises(AssertionError, match="h_s"):
            cs._check_freeze(off, plain, model, F64, "eq", projections=projections)
    start = dict(plain, h_s=np.zeros(4))
    with pytest.raises(AssertionError, match="h_s"):
        cs._check_increment(dict(plain, h_s=plain["h_s"] * (1 + 1e-8)), plain, start, F64, "eq", ("h_s",))


def test_change_bar_carries_the_projections_allowance():
    """``carried_allowance`` is n times one projection's allowance for an
    equilibrium model after n > 1 projections in f64 (none after one, in
    f32, or under the rate scheme), and ``_check_increment`` adds it to each
    field's bar."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    rate, Y, _, _ = cs._load_golden_config().build_freeze_model_and_state(F64, "cpu")
    eq = dataclasses.replace(rate, freeze_thaw=EquilibriumFreezeThaw())
    water, energy = cs._check_freeze(cs._np(Y), cs._np(Y), eq, F64, "eq")
    extra = cs.carried_allowance(eq, F64, 32)
    assert extra == {"vartheta_l": 32 * water, "theta_i": 32 * water, "rho_e_int": 32 * energy}
    assert cs.carried_allowance(eq, F64, 1) is None and cs.carried_allowance(rate, F64, 32) is None
    assert cs.carried_allowance(eq, torch.float32, 32) is None
    start = cs._np(Y)
    plain = dict(start, theta_i=start["theta_i"] + 1e-3)
    kern = dict(plain, theta_i=plain["theta_i"] + 10 * water)
    with pytest.raises(AssertionError, match="theta_i"):
        cs._check_increment(kern, plain, start, F64, "eq", ("theta_i",))
    cs._check_increment(kern, plain, start, F64, "eq", ("theta_i",), extra)
