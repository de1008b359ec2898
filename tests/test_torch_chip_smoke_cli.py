"""Helpers of ``chip_smoke.py`` phase 15 (the run-file CLI and the explicit
steppers of ``csrc/rk_kernel.cu``) on the CPU, without a GPU.

- 15a's paths cover every new (stepper, mode) instance once: ForwardEuler,
  SSPRK22 and SSPRK104 in the ten plain-soil modes, and all four explicit
  steppers in the six branch-policy modes;
- the ptxas report parser and the kernel records name the rk instances and
  their source; the bound counts one rhs sweep per stage;
- 15b's model is ``bench.py::build``'s with Ksat drawn per column, and its
  run file round-trips through the port's and the JAX package's configs;
- 15c's column and step sizes give the steppers' orders through the fused
  run's plain version (the same check the phase makes through the kernels).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import importlib.util
import json
import math
import os

import numpy as np
import torch

from landhydrology_tpu.config import from_config as jax_from_config
from landhydrology_tpu_torch.config import to_config
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def test_rk_cases_cover_every_new_instance():
    names = []
    for model, Y, dt, steppers, moving, freeze in cs.rk_cases(torch.float64, "cpu", 8):
        for name in steppers:
            run = ck.make_fused_column_run(model, cs._stepper(name), dt=dt, steps_per_call=cs.RK_STEPS)
            assert ck._entry(run.mode, torch.float64)[0] == "rk_kernel"
            names.append(run.name)
    assert len(names) == len(set(names)) == 3 * 10 + 4 * 6
    plain_modes = ("B1", "B2", "B1-no-ice", "B2-no-ice", "B3-rate", "B2+B3-rate", "B3-eq", "B2+B3-eq", "B1-water",
                   "B1-heat")
    expect = {f"{m}@{s}" for m in plain_modes for s in cs.RK_STEPPERS}
    for branch in ("water", "heat"):
        for policy in ("B2-{}", "B1-{}-no-ice", "B2-{}-no-ice"):
            mode = policy.format(branch)
            expect |= {mode} | {f"{mode}@{s}" for s in cs.RK_STEPPERS}
    assert set(names) == expect


def test_registers_kernel_of_and_bounds_of_the_rk_instances(tmp_path):
    report = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116rk_column_kernelIdLi131089EEEv10KernelArgsdd' "
              "for 'sm_90a'\nptxas info    : Used 122 registers, used 0 barriers\n")
    libs = {}
    for name in ck.SOURCES:
        libs[name] = tmp_path / f"{name}.so"
        (tmp_path / f"{name}.ptxas.txt").write_text(report if name == "rk_kernel" else "")
    assert cs.registers(ck, libs) == {"f64, rk:B2-water": 122}
    kernel, source = cs.kernel_of(ck, ck.MODE_SSPRK104 | ck.MODE_FREEZE_EQ, torch.float32)
    assert kernel == "rk_column_kernel" and source == "landhydrology_tpu_torch/csrc/rk_kernel.cu"
    one, three, ten = (cs.cell_step_ops(ck, m)["exp"] for m in (ck.MODE_EULER, 0, ck.MODE_SSPRK104))
    assert three == 3 * one and ten == 10 * one
    assert cs.cell_step_ops(ck, ck.MODE_SSPRK104 | ck.MODE_LAGGED)["exp"] < ten
    assert cs.cell_step_ops(ck, ck.MODE_WATER | ck.MODE_LAGGED)["exp"] < cs.cell_step_ops(ck, ck.MODE_WATER)["exp"]


def test_cli_model_and_its_run_file():
    cs.NZ_SAVED, cs.NCOL_SAVED = cs.NZ, cs.NCOL
    try:
        cs.NZ, cs.NCOL = 8, 16
        model = cs.cli_model(torch.float64, "cpu", seed=3)
        Ksat = model.hydrology_model.hydraulic_model.Ksat
        base = cs.build_bench_model(8, 16, torch.float64, "cpu")[0].hydrology_model.hydraulic_model.Ksat
        ratio = (Ksat / base).numpy()
        assert Ksat.shape == (16,) and ratio.min() >= 0.5 and ratio.max() <= 2.0
        cfg = json.loads(json.dumps(to_config(model)))
        assert cfg["hydrology_model"]["hydraulic_model"]["Ksat"]["dtype"] == "float64"
        assert type(jax_from_config(cfg)).__name__ == "SoilModel"
    finally:
        cs.NZ, cs.NCOL = cs.NZ_SAVED, cs.NCOL_SAVED


def test_order_column_gives_the_orders_through_the_plain_version():
    model, Y0 = cs.order_model("cpu")
    fields = ("vartheta_l", "rho_e_int")

    def solve(name, n):
        Y = {g: {k: v.clone() for k, v in f.items()} for g, f in Y0.items()}
        run = ck.make_fused_column_run(model, cs._stepper(name), dt=cs.ORDER_HORIZON / n, steps_per_call=n)
        return cs._np(run(Y, 0.0))

    ref = solve("SSPRK104", 2 * cs.ORDER_STEPS * cs.ORDER_REF)  # 16x the finest step: its error 1e-5 of theirs
    for p, name in ((1, "ForwardEuler"), (4, "SSPRK104")):
        errs = []
        for n in (2 * cs.ORDER_STEPS, 4 * cs.ORDER_STEPS):
            got = solve(name, n)
            errs.append(max(float(np.max(np.abs(got[k] - ref[k]))) / float(np.max(np.abs(ref[k]))) for k in fields))
        assert abs(math.log2(errs[0] / errs[1]) - p) < 0.35 and min(errs) > 1e-10, (name, errs)
