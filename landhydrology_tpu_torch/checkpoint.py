"""Checkpoint / resume.

PyTorch port of ``landhydrology_tpu/checkpoint.py`` in its ``.npz`` layout,
so a checkpoint written by either package restores in the other:
``<directory>/step_<step:012d>.npz`` holds the state's leaves under their
``/``-joined dict paths (``soil/vartheta_l``, ``surface/h_s``) and the time
as the float64 scalar ``__t``; it is written to ``.tmp.npz`` first and
renamed into place, so an interrupted save is never selected.  The port has
no orbax: an ``.orbax`` checkpoint (the JAX package's other layout) counts
as a step and raises on restore, naming it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree: dict, prefix: str = "") -> dict:
    """``{"a/b": array}`` of a nested dict of tensors, keys in sorted order
    at every level (the JAX package's ``tree_flatten_with_path`` keys)."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        leaf = tree[key]
        if isinstance(leaf, dict):
            flat.update(_flatten_with_paths(leaf, path + "/"))
        else:
            flat[path] = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    return flat


def _unflatten_like(template: dict, flat: dict, prefix: str = "") -> dict:
    """The template's structure with each leaf from ``flat``, in the leaf's
    dtype on its device."""
    out = {}
    for key, leaf in template.items():
        path = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out[key] = _unflatten_like(leaf, flat, path + "/")
        else:
            out[key] = torch.as_tensor(flat[path]).to(dtype=leaf.dtype, device=leaf.device)
    return out


class CheckpointManager:
    """Directory of numbered checkpoints with ``save``/``restore``/``latest``.

    ``save(step, Y, t)`` writes atomically (tmp + rename).  ``restore(Y_like,
    step=None)`` returns ``(Y, t, step)`` with tensors cast to the template's
    dtypes on its devices (so an f64-written checkpoint restores into an f32
    run and vice versa).  ``use_orbax`` is accepted for the JAX package's
    signature; ``True`` raises, as the port has no orbax.
    """

    def __init__(self, directory: str, use_orbax: Optional[bool] = None):
        if use_orbax:
            raise ValueError("the PyTorch port writes the .npz layout only: orbax is not available")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.use_orbax = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def save(self, step: int, Y: dict, t: float) -> str:
        path = self._path(step)
        tmp = path + ".tmp.npz"
        np.savez(tmp, __t=float(t), **_flatten_with_paths(Y))
        os.replace(tmp, path + ".npz")
        return path + ".npz"

    def steps(self):
        out = []
        for name in os.listdir(self.directory):
            # an interrupted save leaves a .tmp.npz, which never counts
            if name.startswith("step_") and (
                name.endswith(".npz") and not name.endswith(".tmp.npz") or name.endswith(".orbax")
            ):
                out.append(int(name.split("_")[1].split(".")[0]))
        return sorted(set(out))

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, Y_template: dict, step: Optional[int] = None) -> Tuple:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        if not os.path.exists(path + ".npz") and os.path.exists(path + ".orbax"):
            raise ValueError(
                f"{path}.orbax is an orbax checkpoint, which the PyTorch port cannot read: "
                "write it with CheckpointManager(..., use_orbax=False) in the JAX package"
            )
        with np.load(path + ".npz") as data:
            t = float(data["__t"])
            flat = {k: data[k] for k in data.files if k != "__t"}
        return _unflatten_like(Y_template, flat), t, step
