"""The port's checkpoints (``landhydrology_tpu_torch/checkpoint.py``) against
the JAX package's ``.npz`` layout (``CheckpointManager(use_orbax=False)``).

A checkpoint the JAX package writes restores in the port bit for bit, and
one the port writes restores in the JAX package bit for bit: the same file
name, the same ``/``-joined keys, the time as ``__t``.  An interrupted save
(``.tmp.npz``) is never selected; an ``.orbax`` checkpoint raises naming
it; restores cast to the template's dtype.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu.checkpoint import CheckpointManager as JManager
from landhydrology_tpu_torch.checkpoint import CheckpointManager
from landhydrology_tpu_torch.convert import state_from_numpy
from tests.data import golden_config as gc


def _land_state():
    _, Y, _, _ = gc.build_land_model_and_state(jnp.float64)
    return Y  # soil fields and the pond


def _equal(a, b):
    for g in b:
        for k, v in b[g].items():
            x = a[g][k]
            x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
            assert x.dtype == np.asarray(v).dtype
            assert np.array_equal(x, np.asarray(v)), (g, k)


def test_jax_checkpoint_restores_in_port(tmp_path):
    Y = _land_state()
    JManager(str(tmp_path), use_orbax=False).save(12, Y, 345.25)
    m = CheckpointManager(str(tmp_path))
    assert m.steps() == [12] and m.latest() == 12
    template = state_from_numpy(Y, device="cpu")
    Yr, t, step = m.restore(template)
    assert (t, step) == (345.25, 12)
    _equal(Yr, Y)


def test_port_checkpoint_restores_in_jax(tmp_path):
    Y = state_from_numpy(_land_state(), device="cpu")
    path = CheckpointManager(str(tmp_path)).save(7, Y, 60.0)
    assert os.path.basename(path) == "step_000000000007.npz"
    with np.load(path) as data:
        assert sorted(data.files) == ["__t", "soil/rho_e_int", "soil/theta_i", "soil/vartheta_l", "surface/h_s"]
    Yr, t, step = JManager(str(tmp_path), use_orbax=False).restore(_land_state())
    assert (t, step) == (60.0, 7)
    _equal({g: {k: v.numpy() for k, v in f.items()} for g, f in Y.items()}, Yr)


def test_tmp_orbax_and_casts(tmp_path):
    Y = state_from_numpy(_land_state(), device="cpu")
    m = CheckpointManager(str(tmp_path))
    m.save(3, Y, 1.0)
    np.savez(os.path.join(tmp_path, "step_000000000009.tmp.npz"), __t=2.0)
    assert m.latest() == 3  # an interrupted save does not count
    f32 = {g: {k: v.float() for k, v in f.items()} for g, f in Y.items()}
    Yr, _, _ = m.restore(f32)
    assert all(v.dtype == torch.float32 for f in Yr.values() for v in f.values())
    os.makedirs(os.path.join(tmp_path, "step_000000000020.orbax"))
    assert m.latest() == 20
    with pytest.raises(ValueError, match="step_000000000020.orbax"):
        m.restore(Y)
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(str(tmp_path / "other"), use_orbax=True)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(Y)
