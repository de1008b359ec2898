"""The PyTorch port's ``make_rhs`` against the JAX package's, for all four
energy x hydrology branches: on golden #1, on the two BC pairs and the
heterogeneous case of ``test_pallas_kernel.py``, and on configurations with
Dirichlet faces, ice and the conductivity factors.  The JAX model is carried
over with ``convert.model_from_reference``.  Bar: rtol 1e-13 in float64,
relative to each field's largest tendency: a tendency is a difference of
face fluxes, which cancels where neighbouring fluxes are nearly equal, so
elementwise relative errors of such near-zero entries carry no meaning."""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landhydrology_tpu import (
    Column,
    Dirichlet,
    FreeDrainage,
    PrescribedHydrologyModel,
    PrescribedTemperatureModel,
    SoilColumnBC,
    SoilComponentBC,
    SoilEnergyModel,
    SoilHydrologyModel,
    SoilModel,
    SoilParams,
    VerticalFlux,
)
from landhydrology_tpu.domains import make_function_space
from landhydrology_tpu.models.soil import IceImpedance, TemperatureDependentViscosity, vanGenuchten
from landhydrology_tpu.models.soil.rhs import make_rhs as jax_make_rhs
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from tests.data.golden_config import build_model_and_state
from tests.test_pallas_kernel import NCOL, NZ, _model, _state

RTOL = 1e-13


def _assert_rhs_equal(jmodel, Y, Ya, t):
    """Port rhs == JAX rhs on the same model, state and time."""
    ref = jax_make_rhs(jmodel)(Y, Ya, jnp.asarray(t, dtype=jnp.float64))
    model = model_from_reference(jmodel, device="cpu")
    got = make_rhs(model)(
        state_from_numpy(Y, device="cpu"), state_from_numpy(Ya, device="cpu"), torch.tensor(t, dtype=torch.float64)
    )
    got, ref = state_to_numpy(got), {k: {f: np.asarray(v) for f, v in d.items()} for k, d in ref.items()}
    assert got.keys() == ref.keys() and got["soil"].keys() == ref["soil"].keys()
    for k in ref["soil"]:
        scale = float(np.max(np.abs(ref["soil"][k])))
        np.testing.assert_allclose(
            got["soil"][k], ref["soil"][k], rtol=RTOL, atol=RTOL * scale, err_msg=k
        )


@pytest.mark.parametrize("t", [0.0, 37.5])
def test_rhs_golden_config(t):
    jmodel, Y, Ya, _ = build_model_and_state(jnp.float64)
    _assert_rhs_equal(jmodel, Y, Ya, t)


def _aux(jmodel):
    grid = make_function_space(jmodel.domain, jnp.float64)
    return {"zc": grid.zc, "soil": {}}


@pytest.mark.parametrize(
    "top,bottom",
    [(VerticalFlux(0.0), FreeDrainage()), (Dirichlet(lambda t: 0.4), VerticalFlux(0.0))],
    ids=["flux_free_drainage", "dirichlet_flux"],
)
def test_rhs_bc_pairs(top, bottom):
    jmodel = _model(top, bottom)
    _assert_rhs_equal(jmodel, _state(), _aux(jmodel), 0.0)


def _heterogeneous(base):
    rng = np.random.default_rng(3)
    hm = vanGenuchten(
        n=jnp.asarray(rng.uniform(1.5, 3.5, NCOL)),
        alpha=jnp.asarray(rng.uniform(1.5, 4.0, NCOL)),
        Ksat=jnp.asarray(rng.uniform(1e-7, 1e-5, NCOL)),
        theta_r=jnp.asarray(rng.uniform(0.0, 0.05, NCOL)),
    )
    sp = dataclasses.replace(base.soil_param_set, nu=jnp.asarray(rng.uniform(0.45, 0.55, NCOL)))
    return dataclasses.replace(
        base,
        hydrology_model=dataclasses.replace(base.hydrology_model, hydraulic_model=hm),
        soil_param_set=sp,
    )


def test_rhs_heterogeneous_params():
    jmodel = _heterogeneous(_model(VerticalFlux(0.0), FreeDrainage()))
    _assert_rhs_equal(jmodel, _state(), _aux(jmodel), 0.0)


def _icy_state(seed=5):
    rng = np.random.default_rng(seed)
    Y = _state()
    theta_i = 0.04 * rng.random((NZ, NCOL))
    theta_i[:, :8] = 0.0  # ice-free columns beside icy ones
    Y["soil"]["theta_i"] = jnp.asarray(theta_i)
    return Y


@pytest.mark.parametrize("face", ["bottom", "top"])
def test_rhs_dirichlet_faces_with_ice_and_factors(face):
    """Dirichlet hydrology AND energy at one face (both face values enter
    both fluxes), flux BCs at the other, with ice, viscosity and impedance."""
    base = _heterogeneous(_model(VerticalFlux(0.0), FreeDrainage()))
    dirichlet = SoilComponentBC(
        hydrology=Dirichlet(lambda t: 0.38 + 1e-4 * t), energy=Dirichlet(jnp.linspace(280.0, 290.0, NCOL))
    )
    flux = SoilComponentBC(hydrology=VerticalFlux(lambda t: -1e-7 + 0.0 * t), energy=VerticalFlux(3.0))
    bcs = SoilColumnBC(top=dirichlet, bottom=flux) if face == "top" else SoilColumnBC(top=flux, bottom=dirichlet)
    jmodel = dataclasses.replace(
        base,
        boundary_conditions=bcs,
        hydrology_model=dataclasses.replace(
            base.hydrology_model,
            viscosity_factor=TemperatureDependentViscosity(),
            impedance_factor=IceImpedance(),
        ),
    )
    _assert_rhs_equal(jmodel, _icy_state(), _aux(jmodel), 12.0)


def test_rhs_assume_no_ice():
    jmodel = dataclasses.replace(_model(VerticalFlux(0.0), FreeDrainage()), assume_no_ice=True)
    _assert_rhs_equal(jmodel, _state(), _aux(jmodel), 0.0)


def _column_model(energy, hydrology, bcs):
    return SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=NZ, batch_shape=(NCOL,)),
        energy_model=energy,
        hydrology_model=hydrology,
        boundary_conditions=bcs,
        soil_param_set=SoilParams(nu=0.45, rho_c_ds=1.2e6),
        dtype=jnp.float64,
    )


@pytest.mark.parametrize("profile", ["default", "callable"])
def test_rhs_water_only(profile):
    energy = (
        PrescribedTemperatureModel()
        if profile == "default"
        else PrescribedTemperatureModel(T_profile=lambda z, t: 283.0 + 2.0 * z + 0.0 * t)
    )
    jmodel = _column_model(
        energy,
        SoilHydrologyModel(viscosity_factor=TemperatureDependentViscosity()),
        SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.4)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
    )
    Y = {"soil": {k: _icy_state()["soil"][k] for k in ("vartheta_l", "theta_i")}}
    Ya = {"zc": _aux(jmodel)["zc"], "soil": {"T": energy.T_profile(_aux(jmodel)["zc"], 0.0)}}
    _assert_rhs_equal(jmodel, Y, Ya, 4.0)


def test_rhs_heat_only():
    hydrology = PrescribedHydrologyModel(
        vartheta_l_profile=lambda z, t: 0.3 + 0.05 * z + 0.0 * t,
        theta_i_profile=lambda z, t: 0.01 + 0.0 * z,
    )
    jmodel = _column_model(
        SoilEnergyModel(),
        hydrology,
        SoilColumnBC(
            top=SoilComponentBC(energy=Dirichlet(lambda t: 290.0 + 0.0 * t)),
            bottom=SoilComponentBC(energy=VerticalFlux(1.5)),
        ),
    )
    Y = {"soil": {"rho_e_int": _state()["soil"]["rho_e_int"]}}
    zc = _aux(jmodel)["zc"]
    Ya = {"zc": zc, "soil": {"vartheta_l": hydrology.vartheta_l_profile(zc, 0.0),
                             "theta_i": hydrology.theta_i_profile(zc, 0.0)}}
    _assert_rhs_equal(jmodel, Y, Ya, 0.0)


def test_rhs_no_dynamics():
    jmodel = _column_model(PrescribedTemperatureModel(), PrescribedHydrologyModel(), SoilColumnBC())
    zc = _aux(jmodel)["zc"]
    Ya = {"zc": zc, "soil": {"T": jnp.full_like(zc, 288.0), "vartheta_l": jnp.zeros_like(zc),
                             "theta_i": jnp.zeros_like(zc)}}
    assert make_rhs(model_from_reference(jmodel, device="cpu"))({"soil": {}}, state_from_numpy(Ya, device="cpu"), 0.0) == {"soil": {}}


def test_rhs_missing_bc_raises():
    jmodel = _column_model(
        SoilEnergyModel(),
        SoilHydrologyModel(),
        SoilColumnBC(top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
                     bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0))),
    )
    with pytest.raises(ValueError, match="f_rho_e_int"):
        make_rhs(model_from_reference(jmodel, device="cpu"))(state_from_numpy(_state(), device="cpu"), state_from_numpy(_aux(jmodel), device="cpu"), 0.0)
