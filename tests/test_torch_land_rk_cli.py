"""A LandModel run file under SSPRK104 on the fused engine: the port's
``cli.cmd_run(path, device="cpu")`` (the land kernel's plain version on the
CPU, ``B6@SSPRK104``) against the JAX package's ``cli.cmd_run(path)`` (its
Pallas kernel in interpret mode): the saved states agree at rtol 1e-12.

The model is ``test_torch_land.py::_jax_land``'s LandModel (MOST top, a
rain pulse, a pond) on 32 columns, written by the JAX package's
``to_config`` with ``"stepper": "SSPRK104"``, ``"engine": "pallas"``: 8
steps of 2 s in launches of 4, saved every 4 steps.  ``chip_smoke.py``
phase 18b drives the same kind of file at nz=64 x 65,536 on the card.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import copy

from landhydrology_tpu.config import to_config as jax_to_config
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_cli import _run_both
from tests.test_torch_land import _jax_land


def land_cfg(stepper):
    model = jax_to_config(_jax_land())
    model["soil"]["domain"]["batch_shape"] = [32]
    return {"model": model,
            "initial_conditions": {"kind": "constant", "vartheta_l": 0.22, "T": 291.0, "h_s0": 1e-4},
            "simulation": {"dt": 2.0, "t_final": 16.0, "saveat": 8.0, "stepper": stepper, "engine": "pallas",
                           "steps_per_call": 4, "tile_cols": 32}}


def test_ssprk104_land_file_matches_jax(tmp_path):
    cfg = land_cfg("SSPRK104")
    before = dict(ck.LAUNCHES)
    out = _run_both(tmp_path, copy.deepcopy(cfg), "land_rk104",
                    expect_keys=("t", "vartheta_l", "theta_i", "rho_e_int", "surface/h_s"))
    assert ck.LAUNCHES == before  # the plain version on the CPU launches nothing
    assert list(out["port"]["t"]) == [0.0, 8.0, 16.0]
    h_s = out["port"]["surface/h_s"]
    assert h_s.shape == (3, 32) and not (h_s[-1] == h_s[0]).all()
