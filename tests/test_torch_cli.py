"""The port's run-file CLI (``landhydrology_tpu_torch/cli.py``) against the
JAX package's ``cli.py`` on the same JSON run files, on the CPU.

``cli.cmd_run(path, device="cpu")`` and the JAX package's
``cli.cmd_run(path)`` write ``.npz`` files with the same keys whose arrays
agree at rtol 1e-12 (f64): the example run file, a per-column
heterogeneous one, SSPRK104 with ``"engine": "pallas"`` (the port's fused
run, JAX's Pallas kernel in interpret mode), hydrostatic initial conditions
with a checkpoint and a resumed run (the port resumes on the run file's
engine, JAX on XLA: the same steps), an adaptive run and the flagship
LandModel on the eager engine.  ``describe`` and ``example`` print the JAX
package's text (``describe`` adds the port's device line).
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import contextlib
import copy
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from landhydrology_tpu import cli as jcli
from landhydrology_tpu_torch import cli

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(flagship=False, module=cli):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.cmd_example(flagship=flagship)
    return json.loads(buf.getvalue()), buf.getvalue()


def _run_both(tmp_path, cfg, tag, expect_keys=("t", "vartheta_l", "theta_i", "rho_e_int")):
    """Run ``cfg`` through both CLIs (separate outputs and checkpoint
    directories); returns the two ``.npz`` contents."""
    out = {}
    for name, run in (("jax", jcli.cmd_run), ("port", lambda p: cli.cmd_run(p, device="cpu"))):
        c = copy.deepcopy(cfg)
        c["output"] = {"path": str(tmp_path / f"{tag}_{name}.npz")}
        if "checkpoint" in c:
            c["checkpoint"] = {"directory": str(tmp_path / f"ckpt_{tag}_{name}")}
        path = tmp_path / f"{tag}_{name}.json"
        path.write_text(json.dumps(c))
        assert run(str(path)) == 0
        with np.load(c["output"]["path"]) as data:
            out[name] = {k: data[k] for k in data.files}
    assert sorted(out["port"]) == sorted(out["jax"])
    assert set(expect_keys) <= set(out["port"])
    for k, ref in out["jax"].items():
        got = out["port"][k]
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * float(np.max(np.abs(ref))), err_msg=k)
    return out


def test_example_file_matches_jax(tmp_path):
    cfg, text = _example()
    assert text == _example(module=jcli)[1]
    cfg["simulation"] = {"dt": 50.0, "t_final": 5000.0, "saveat": 2500.0, "stepper": "SSPRK33"}
    out = _run_both(tmp_path, cfg, "example")
    assert out["port"]["vartheta_l"].shape[0] == 3


def test_heterogeneous_file_matches_jax(tmp_path):
    """Per-column soil parameters as arrays of the config format, ForwardEuler."""
    cfg, _ = _example()
    rng = np.random.default_rng(4)
    ncol = 6
    cfg["model"]["domain"]["batch_shape"] = [ncol]
    hm = cfg["model"]["hydrology_model"]["hydraulic_model"]
    for name, lo, hi in (("Ksat", 1e-7, 1e-6), ("n", 1.5, 2.5), ("alpha", 1.5, 3.0)):
        hm[name] = {"__array__": rng.uniform(lo, hi, ncol).tolist(), "dtype": "float64"}
    cfg["model"]["dtype"] = {"__dtype__": "float64"}
    cfg["initial_conditions"] = {"kind": "constant", "vartheta_l": 0.3, "T": 285.0}
    cfg["simulation"] = {"dt": 20.0, "t_final": 2000.0, "saveat": 1000.0, "stepper": "ForwardEuler"}
    _run_both(tmp_path, cfg, "hetero")


def _fused_cfg(stepper, t_final):
    """The example's soil on 32 columns from a hydrostatic state (water
    table at -1 m), fused: dt = 10 s is under the explicit limit of its
    saturated zone (16.8 s, ``diagnostics.explicit_dt_limit``)."""
    cfg, _ = _example()
    cfg["model"]["domain"]["batch_shape"] = [32]
    cfg["initial_conditions"] = {"kind": "hydrostatic", "z_table": -1.0, "T": 290.0}
    cfg["simulation"] = {"dt": 10.0, "t_final": t_final, "saveat": 100.0, "stepper": stepper,
                         "engine": "pallas", "steps_per_call": 10, "tile_cols": 32}
    return cfg


def test_ssprk104_pallas_file_matches_jax(tmp_path):
    _run_both(tmp_path, _fused_cfg("SSPRK104", 200.0), "rk104")


def test_hydrostatic_checkpoint_resume_matches_jax(tmp_path):
    """A fused SSPRK22 run with a checkpoint, then the same file over a
    longer horizon: each CLI resumes from its own checkpoint (the port on
    its fused engine, the JAX package on XLA) and the resumed trajectories
    agree at rtol 1e-12."""
    cfg = _fused_cfg("SSPRK22", 200.0)
    cfg["checkpoint"] = {"directory": "set per CLI"}
    first = _run_both(tmp_path, cfg, "resume")
    prof0 = first["port"]["vartheta_l"][0]
    assert prof0[-1, 0] < prof0[0, 0]  # drier toward the surface above the water table
    cfg["simulation"]["t_final"] = 400.0
    resumed = _run_both(tmp_path, cfg, "resume")  # the same directories: both resume at t = 200
    assert resumed["port"]["t"][0] == 200.0 and resumed["port"]["t"][-1] == 400.0
    assert os.path.exists(tmp_path / "ckpt_resume_port" / "step_000000000040.npz")


def test_adaptive_file_matches_jax(tmp_path):
    cfg, _ = _example()
    cfg["simulation"] = {"dt": 50.0, "t_final": 3000.0, "stepper": "SSPRK33",
                         "adaptive": {"rtol": 1e-4, "atol": 1e-8}}
    out = _run_both(tmp_path, cfg, "adaptive")
    assert list(out["port"]["t"]) == [0.0, 3000.0]


def test_flagship_land_file_matches_jax(tmp_path):
    cfg, text = _example(flagship=True)
    assert text == _example(flagship=True, module=jcli)[1]
    cfg["simulation"]["t_final"] = 30.0
    cfg["simulation"]["saveat"] = 15.0
    out = _run_both(tmp_path, cfg, "flagship", expect_keys=("t", "vartheta_l", "surface/h_s"))
    assert out["port"]["surface/h_s"].shape == (3, 16, 16)


def test_describe_prints_the_jax_text(tmp_path, capsys):
    cfg = _fused_cfg("SSPRK104", 200.0)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(cfg))
    assert jcli.cmd_describe(str(path)) == 0
    ref = capsys.readouterr().out
    assert cli.cmd_describe(str(path), device="cpu") == 0
    got = capsys.readouterr().out
    assert got == ref + "device: cpu\n"
    with pytest.raises(KeyError, match="unknown engine"):
        cfg["simulation"]["engine"] = "tpu"
        path.write_text(json.dumps(cfg))
        cli.load_run(str(path), device="cpu")
    with pytest.raises(KeyError):
        cli._build_stepper("NoSuchStepper")


def test_main_needs_a_card_or_cpu(tmp_path, capsys):
    path = tmp_path / "run.json"
    cfg, _ = _example()
    cfg["simulation"] = {"dt": 100.0, "t_final": 200.0, "saveat": 100.0}
    cfg["output"] = {"path": str(tmp_path / "out.npz")}
    path.write_text(json.dumps(cfg))
    if not torch.cuda.is_available():
        assert cli.main(["run", str(path)]) == 2
        assert "--device cpu" in capsys.readouterr().err
    assert cli.main(["run", str(path), "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "out.npz")
    proc = subprocess.run([sys.executable, "-m", "landhydrology_tpu_torch", "example"], capture_output=True,
                          text=True, timeout=240, cwd=HERE)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["model"]["__type__"] == "SoilModel"
