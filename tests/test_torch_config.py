"""The port's config serialization (``landhydrology_tpu_torch/config.py``)
against the JAX package's ``config.py``.

- ``to_config`` of every model the builders of
  ``tests/data/golden_config_torch.py`` make that serializes equals, as a
  dict, the JAX package's ``to_config`` of the same model (the builders'
  JAX counterparts): no ``device``, the dtype ``{"__dtype__": "float64"}``,
  per-column arrays as ``{"__array__": [...], "dtype": "float64"}``.  A
  builder's model that serializes without a JAX counterpart here fails.
- ``from_config`` of the JAX package's dict builds a model, on the asked
  device, whose rhs equals the JAX package's at rtol 1e-13 (atol 1e-13 of
  the field's largest value, for cancelled entries); the dict round
  trips; callables raise ``TypeError`` as in the JAX package.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import Column as JColumn
from landhydrology_tpu.config import from_config as jax_from_config
from landhydrology_tpu.config import to_config as jax_to_config
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.models import land as jland
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch.config import from_config, to_config
from landhydrology_tpu_torch.convert import state_from_numpy
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.models import land as pland
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from tests.data import golden_config as gc
from tests.data import golden_config_torch as gct
from tests.test_adaptive import _tiny_land

F64 = torch.float64


def _jax_land():
    return gc.build_land_model_and_state(jnp.float64)[0]


def _jax_forced():
    return gc.build_forced_model_state_and_rows(jnp.float64)[0]


def _jax_most(name):
    """The JAX counterpart of ``gct.build_most_case(name)``'s model."""
    case, land = gct.MOST_CASES[name], _jax_land()
    if case["model"] == "land":
        return dataclasses.replace(land, surface=dataclasses.replace(land.surface, runoff=None))
    return dataclasses.replace(
        land.soil, domain=JColumn(zlim=(-1.5, 0.0), nelements=gc.LAND_NZ, batch_shape=(gc.LAND_NX * gc.LAND_NY,)),
        coefficient_update="step" if case["lagged"] else "stage")


def _jax_tiny_land():
    """``tests/test_adaptive.py::_tiny_land`` at the port builder's float64
    (JAX's model leaves its dtype to the default float, float64 here)."""
    land = _tiny_land()[0]
    return dataclasses.replace(land, soil=dataclasses.replace(land.soil, dtype=jnp.float64))


#: each serializing builder (and case) of golden_config_torch.py, with the
#: JAX package's model it builds
JAX_COUNTERPARTS = {
    "build_land_model_and_state": _jax_land,
    "build_forced_model_state_and_rows": _jax_forced,
    "build_tiny_land": _jax_tiny_land,
    "build_adaptive_case[b]": _jax_forced,
    "build_adaptive_test[land7]": _jax_tiny_land,
    "build_adaptive_test[forced_fused]": _jax_forced,
    "build_adaptive_test[forced_segments]": _jax_forced,
    "build_adaptive_test[forced_trbdf2]": _jax_forced,
    **{f"build_most_case[{n}]": (lambda n=n: _jax_most(n)) for n in gct.MOST_CASES},
}
CASES = {"build_adaptive_case": ("a", "b"), "build_adaptive_test": tuple(gct.ADAPTIVE_TESTS),
         "build_grad_case": tuple(gct.GRAD_CASES), "build_most_case": tuple(gct.MOST_CASES)}


def _port_models():
    """``{builder id: port model}`` of every builder of golden_config_torch.py."""
    out = {}
    for name, fn in inspect.getmembers(gct, inspect.isfunction):
        if not name.startswith("build_"):
            continue
        if name in CASES:
            for c in CASES[name]:
                out[f"{name}[{c}]"] = fn(c, F64, device="cpu")[0]
        else:
            out[name] = fn(F64, device="cpu")[0]
    return out


def test_to_config_equals_jax_for_every_builder():
    serialized = 0
    for key, model in _port_models().items():
        try:
            cfg = to_config(model)
        except TypeError as err:
            assert "callable" in str(err), (key, err)
            assert key not in JAX_COUNTERPARTS, key
            continue
        assert key in JAX_COUNTERPARTS, f"{key} serializes but has no JAX counterpart in this test"
        ref = jax_to_config(JAX_COUNTERPARTS[key]())
        assert cfg == ref, key
        assert json.loads(json.dumps(cfg)) == cfg
        serialized += 1
    assert serialized == len(JAX_COUNTERPARTS)


def _rhs_pair(jm, model):
    """``(JAX rhs, port rhs, JAX grid, port grid)`` of a JAX model and the
    port's model of the same config."""
    if isinstance(jm, jland.LandModel):
        jgrid = jax_grid(jm.soil.domain, jnp.float64)
        grid = make_function_space(model.soil.domain, F64, "cpu")
        return jland.make_rhs(jm, jgrid), pland.make_rhs(model, grid), jgrid, grid
    jgrid = jax_grid(jm.domain, jnp.float64)
    grid = make_function_space(model.domain, F64, "cpu")
    return jax_make_rhs(jm, jgrid), make_rhs(model, grid), jgrid, grid


@pytest.mark.parametrize("which", ["land", "forced", "tiny_land"])
def test_from_config_of_jax_dict_matches_jax_rhs(which):
    if which == "land":
        jm, Y, Ya, _ = gc.build_land_model_and_state(jnp.float64)
    elif which == "forced":
        jm, Y, Ya, _, _ = gc.build_forced_model_state_and_rows(jnp.float64)
    else:
        jm, Y, Ya = _tiny_land()
        jm = _jax_tiny_land()
    cfg = json.loads(json.dumps(jax_to_config(jm)))
    model = from_config(cfg, device="cpu")
    assert to_config(model) == cfg
    soil = getattr(model, "soil", model)
    assert soil.device == "cpu" and soil.dtype == F64
    jrhs, rhs, jgrid, grid = _rhs_pair(jm, model)
    t = 7.0
    ref = jrhs(Y, {"zc": jgrid.zc, "soil": {}}, jnp.asarray(t))
    got = rhs(state_from_numpy(Y, device="cpu"), {"zc": grid.zc, "soil": {}}, torch.tensor(t, dtype=F64))
    for g in ref:
        for k, v in ref[g].items():
            r = np.asarray(v)
            np.testing.assert_allclose(got[g][k].numpy(), r, rtol=1e-13, atol=1e-13 * float(np.max(np.abs(r))),
                                       err_msg=f"{g}/{k}")
    # the JAX package's from_config takes the port's dict
    assert type(jax_from_config(to_config(model))) is type(jm)


def test_from_config_arrays_dtypes_and_callables():
    model = from_config(jax_to_config(_jax_forced()), device="cpu")
    for leaf in (model.soil_param_set.nu, model.hydrology_model.hydraulic_model.Ksat):
        if torch.is_tensor(leaf):
            assert leaf.device.type == "cpu"
    cfg = jax_to_config(_jax_forced())
    cfg["dtype"] = None  # the JAX package's default float: float64 here
    assert from_config(cfg, device="cpu").dtype == F64
    cfg["dtype"] = {"__dtype__": "float32"}
    assert from_config(cfg, device="cpu").dtype == torch.float32
    golden = gct.build_model_and_state(F64, "cpu")[0]
    with pytest.raises(TypeError, match="callable"):
        to_config(golden)
    with pytest.raises(KeyError, match="unknown config type"):
        from_config({"__type__": "NoSuchModel"})
    with pytest.raises(KeyError, match="unknown fields"):
        from_config({"__type__": "Column", "zlim": [-1.0, 0.0], "nelements": 4, "bogus": 1})
