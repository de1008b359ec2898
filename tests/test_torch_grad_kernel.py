"""The differentiable fused run (kernel mode B9,
``ops/cuda/differentiable.py``) against the JAX package.

On the CPU the forward is the kernel's plain version; the backward is the
same everywhere: the step-by-step replay of the plain version under
``torch.autograd``.

- the analogues of ``tests/test_differentiability.py``'s last three tests:
  the fused run against the eager loop (primal rtol 1e-12, gradient rtol
  1e-10) and central finite differences on three random directions (rtol
  5e-5); the refusals of what JAX refuses (a LandModel, forcing, streamed
  geometry: "differentiable"); d/d dt not zero and equal to finite
  differences (rtol 1e-5);
- ``golden_grad_f64.npz``'s B9 cases (``make_golden_grad.py``: JAX's
  ``make_fused_column_run(..., interpret=True, differentiable=True)``):
  the loss at rtol 1e-12 and the gradients in the start state, t0 and dt at
  rtol 1e-10 of their scale; the builders of ``golden_config_torch`` give
  the golden's start states;
- the B9 run on the land golden's soil (a MOST top: modes B9:B5, B9:B2+B5,
  B9:B4-trbdf2+B5): the loss equals JAX's forward (rtol 1e-12) and its AD
  along the golden's three directions and in dt the fourth-order central
  differences of the JAX package's forward (``most__``), rtol 1e-7 (JAX's
  own B9 there takes ``jax.grad`` of the solve's last false-position step,
  no derivative of the root);
- the step-by-step replay equals the whole launch's graph: bit for bit in
  the state, rtol 1e-14 in t0 and dt; ``run(Y, ...)`` leaves ``Y`` as it
  was;
- a parameter tensor that requires grad raises naming it; on the card
  (``cuda``-marked, skipped without a GPU) a non-differentiable run on a
  state that requires grad raises, and B9's forward is the kernel.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import numpy as np
import pytest
import torch

from landhydrology_tpu_torch import Dirichlet, SoilColumnBC, SoilComponentBC
from landhydrology_tpu_torch.domains import make_function_space
from landhydrology_tpu_torch.imex import TRBDF2Soil
from landhydrology_tpu_torch.models.soil import vanGenuchten
from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
from landhydrology_tpu_torch.models.soil.rhs import make_rhs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.data import golden_config_torch as gct

F64 = torch.float64
GOLDEN = "tests/data/golden_grad_f64.npz"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _t(x, grad=False):
    return torch.tensor(x, dtype=F64, requires_grad=grad)


def _column():
    return gct.build_grad_column(F64, "cpu")


def test_gradient_through_fused_kernel_matches_eager_and_fd():
    """``test_differentiability.py:97``: the B9 run's loss equals the eager
    loop's (rtol 1e-12), its gradient in vartheta_l the eager gradient
    (rtol 1e-10, atol 1e-16), and central differences on three random
    directions (rtol 5e-5, atol 1e-12)."""
    model, Y0 = _column()
    run = ck.make_fused_column_run(model, SSPRK33(), dt=20.0, steps_per_call=6, tile_cols=32,
                                   differentiable=True)

    def loss_fused(v0):
        return torch.mean((run({"soil": dict(Y0["soil"], vartheta_l=v0)}, 0.0)["soil"]["vartheta_l"] - 0.25) ** 2)

    grid = make_function_space(model.domain, F64, "cpu")
    rhs, Ya = make_rhs(model, grid), {"zc": grid.zc, "soil": {}}

    def loss_eager(v0):
        Y, t = {"soil": dict(Y0["soil"], vartheta_l=v0)}, _t(0.0)
        for _ in range(6):
            Y = SSPRK33().step(rhs, Y, Ya, t, _t(20.0))
            t = t + 20.0
        return torch.mean((Y["soil"]["vartheta_l"] - 0.25) ** 2)

    v0 = Y0["soil"]["vartheta_l"].clone().requires_grad_(True)
    lf, le = loss_fused(v0), loss_eager(v0)
    np.testing.assert_allclose(float(lf), float(le), rtol=1e-12)
    (g_fused,) = torch.autograd.grad(lf, v0)
    (g_eager,) = torch.autograd.grad(le, v0)
    np.testing.assert_allclose(g_fused.numpy(), g_eager.numpy(), rtol=1e-10, atol=1e-16)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for _ in range(3):
            d = torch.as_tensor(rng.standard_normal(tuple(v0.shape)))
            d = d / torch.linalg.norm(d)
            eps = 1e-6
            fd = (float(loss_fused(v0 + eps * d)) - float(loss_fused(v0 - eps * d))) / (2 * eps)
            np.testing.assert_allclose(float(torch.sum(g_fused * d)), fd, rtol=5e-5, atol=1e-12)


def test_differentiable_fused_rejects_unsupported():
    """``test_differentiability.py:197``: a LandModel, streamed forcing and
    streamed geometry raise ``NotImplementedError`` naming
    "differentiable"; forcing passed to a call raises ``ValueError``."""
    from landhydrology_tpu_torch.models.land import LandModel, SurfaceWaterModel

    model, Y = _column()
    land = LandModel(soil=model, surface=SurfaceWaterModel(precipitation=lambda t: 1e-6))
    with pytest.raises(NotImplementedError, match="differentiable"):
        ck.make_fused_column_run(land, SSPRK33(), dt=1.0, differentiable=True)
    forced, _, _, rows, _ = gct.build_forced_model_state_and_rows(F64, "cpu")
    with pytest.raises(NotImplementedError, match="differentiable"):
        ck.make_fused_column_run(forced, forcing_fields=("u_atm",), differentiable=True)
    grid = make_function_space(model.domain, F64, "cpu")
    geometry = (torch.full((16,), 0.125, dtype=F64), grid.zc.expand(8, 16).contiguous())
    with pytest.raises(NotImplementedError, match="differentiable"):
        ck.make_fused_column_run(model, streamed_geometry=geometry, differentiable=True)
    run = ck.make_fused_column_run(model, differentiable=True)
    with pytest.raises(ValueError, match="no forcing"):
        run(Y, 0.0, forcing={"u_atm": rows["u_atm"]})


def test_fused_kernel_dt_gradient_not_silently_zero():
    """``test_differentiability.py:245``: d loss / d dt_run is not zero and
    equals central differences (rtol 1e-5)."""
    model, Y = _column()
    run = ck.make_fused_column_run(model, SSPRK33(), dt=20.0, steps_per_call=4, differentiable=True)

    def loss(dt):
        return torch.mean(run(Y, 0.0, dt_run=dt)["soil"]["vartheta_l"] ** 2)

    dt = _t(20.0, grad=True)
    (g,) = torch.autograd.grad(loss(dt), dt)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(loss(_t(20.0 + eps))) - float(loss(_t(20.0 - eps)))) / (2 * eps)
    assert float(g) != 0.0
    np.testing.assert_allclose(float(g), fd, rtol=1e-5)


def _b9_gradients(name, device="cpu"):
    """``(loss, {field: d}, d t0, d dt, start)`` of gradient case ``name``
    through the B9 run on ``device``."""
    model, Y, stepper, case = gct.build_grad_case(name, F64, device)
    run = ck.make_fused_column_run(model, stepper, dt=case["dt"], steps_per_call=case["steps"],
                                   differentiable=True)
    start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
    t0, dt = _t(case["t0"], grad=True), _t(case["dt"], grad=True)
    loss = gct.grad_loss(run({"soil": start}, t0, dt_run=dt)["soil"], {k: v.detach() for k, v in start.items()})
    grads = torch.autograd.grad(loss, list(start.values()) + [t0, dt], allow_unused=True)
    grads = [torch.zeros((), dtype=F64) if d is None else d for d in grads]
    return float(loss), dict(zip(start, grads)), grads[-2], grads[-1], start


@pytest.mark.parametrize("name", list(gct.GRAD_CASES))
def test_b9_matches_the_gradient_golden(name):
    """The B9 run (the plain forward on the CPU) against JAX's B9 frozen in
    ``golden_grad_f64.npz``: the loss at rtol 1e-12, every gradient within
    1e-10 of its scale; the builders give the golden's start state."""
    golden = np.load(GOLDEN)
    loss, grads, g_t0, g_dt, start = _b9_gradients(name)
    np.testing.assert_allclose(loss, float(golden[f"{name}__loss"]), rtol=1e-12)
    for k, d in grads.items():
        np.testing.assert_array_equal(start[k].detach().numpy(), golden[f"{name}__y0_{k}"], err_msg=k)
        ref = golden[f"{name}__g_{k}"]
        scale = float(np.max(np.abs(ref))) or 1.0
        np.testing.assert_allclose(d.numpy(), ref, rtol=0, atol=1e-10 * scale, err_msg=f"{name} d/d{k}")
    for what, d in (("t0", g_t0), ("dt", g_dt)):
        ref = float(golden[f"{name}__g_{what}"])
        np.testing.assert_allclose(float(d), ref, rtol=1e-10, atol=1e-300, err_msg=f"{name} d/d{what}")
    assert float(golden[f"{name}__g_dt"]) != 0.0


def _b9_most(name, device="cpu"):
    """``(run, loss, [AD along the golden's directions], d t0, d dt)`` of
    MOST case ``name`` through the B9 run on ``device``."""
    golden = np.load(GOLDEN)
    model, Y, _, stepper, case = gct.build_most_case(name, F64, device)
    run = ck.make_fused_column_run(model, stepper, dt=case["dt"], steps_per_call=case["steps"],
                                   differentiable=True)
    W = gct.sweep_weights({g: {k: v.cpu().numpy() for k, v in f.items()} for g, f in Y.items()})["soil"]
    start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
    t0, dt = _t(0.0, grad=True).to(device), _t(case["dt"], grad=True).to(device)
    out = run({"soil": start}, t0, dt_run=dt)["soil"]
    loss = sum(torch.sum(torch.as_tensor(W[k]).to(device) * out[k]) for k in out)
    grads = torch.autograd.grad(loss, list(start.values()) + [t0, dt], allow_unused=True)
    grads = [torch.zeros((), dtype=F64) if d is None else d.cpu() for d in grads]
    ad = [sum(float(torch.sum(d * torch.as_tensor(dr["soil"][k]))) for k, d in zip(start, grads))
          for dr in gct.most_fd_directions(golden, name)]
    return run, float(loss), ad, float(grads[-2]), float(grads[-1])


@pytest.mark.parametrize("name", [n for n, c in gct.MOST_CASES.items() if c["model"] == "soil"])
def test_b9_most_soil_matches_jax_differences(name):
    """B9 under a MOST top: the loss equals the JAX package's forward (rtol
    1e-12); AD along the golden's directions and in dt_run equals the
    differences of the JAX package's forward, rtol 1e-7; t0 moves nothing
    (the top's forcing is constant in time)."""
    golden = np.load(GOLDEN)
    run, loss, ad, g_t0, g_dt = _b9_most(name)
    assert run.name == {"most_soil": "B9:B5", "most_lagged": "B9:B2+B5", "most_trbdf2": "B9:B4-trbdf2+B5"}[name]
    np.testing.assert_allclose(loss, float(golden[f"most__{name}__loss"]), rtol=1e-12)
    np.testing.assert_allclose(ad, golden[f"most__{name}__fd"], rtol=1e-7)
    np.testing.assert_allclose(g_dt, float(golden[f"most__{name}__fd_dt"]), rtol=1e-7)
    assert g_t0 == 0.0


def _time_dependent(model):
    """``model`` with a top energy Dirichlet that moves with t, so t0 has a
    gradient."""
    bcs = model.boundary_conditions
    return dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=bcs.top.hydrology, energy=Dirichlet(lambda t: 270.0 + 1e-2 * t)),
        bottom=bcs.bottom))


@pytest.mark.parametrize("case", ["golden1_ssprk33", "freeze_trbdf2_lagged_eq", "freeze_be_soil_rate"])
def test_step_by_step_replay_equals_the_whole_launch(case):
    """B9's backward (one step's graph at a time) against autograd of the
    whole launch's plain version: the state's gradient bit for bit, t0's
    and dt's at rtol 1e-14; the input state is left as it was."""
    if case == "golden1_ssprk33":
        model, Y, _, _ = gct.build_model_and_state(F64, "cpu")
        model, stepper, dt, n = _time_dependent(model), SSPRK33(), 10.0, 5
    else:
        freeze = EquilibriumFreezeThaw() if "eq" in case else FreezeThaw(tau=60.0)
        model, Y, _, _ = gct.build_freeze_model_and_state(F64, "cpu", freeze_thaw=freeze)
        model = _time_dependent(dataclasses.replace(
            model, coefficient_update="step" if "lagged" in case else "stage"))
        grid = make_function_space(model.domain, F64, "cpu")
        from landhydrology_tpu_torch.imex import BackwardEulerSoil

        cls = TRBDF2Soil if "trbdf2" in case else BackwardEulerSoil
        stepper, dt, n = cls(model=model, grid=grid, iters=2), 60.0, 4
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n, differentiable=True)
    start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
    before = {k: v.detach().clone() for k, v in start.items()}
    t0, dt_t = _t(30.0, grad=True), _t(dt, grad=True)
    W = gct.sweep_weights({"soil": {k: v.numpy() for k, v in before.items()}})["soil"]

    def total(out):
        return sum(torch.sum(torch.as_tensor(W[k]) * out[k]) for k in out)

    out = run({"soil": start}, t0, dt_run=dt_t)["soil"]
    for k, v in start.items():
        assert torch.equal(v.detach(), before[k]), k  # Y untouched
    got = torch.autograd.grad(total(out), list(start.values()) + [t0, dt_t])
    whole = ck.fused_column_run_plain(model, stepper, dt_t, n, {"soil": start}, t0)["soil"]
    for k in out:
        assert torch.equal(out[k], whole[k].detach()), k
    ref = torch.autograd.grad(total(whole), list(start.values()) + [t0, dt_t])
    for k, a, b in zip(start, got, ref):
        assert torch.equal(a, b), k
    assert float(ref[-2]) != 0.0 and float(ref[-1]) != 0.0
    np.testing.assert_allclose(float(got[-2]), float(ref[-2]), rtol=1e-14)
    np.testing.assert_allclose(float(got[-1]), float(ref[-1]), rtol=1e-14)


def test_parameter_requiring_grad_raises():
    """A model parameter tensor that requires grad: the run closes over the
    model, so it raises ``ValueError`` naming the parameter (JAX's
    ``custom_vjp`` refuses a closed-over value) instead of returning a zero
    gradient for it."""
    model, Y = _column()
    ksat = torch.tensor(1e-6, dtype=F64, requires_grad=True)
    hm = model.hydrology_model
    m = dataclasses.replace(model, hydrology_model=dataclasses.replace(
        hm, hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=ksat, theta_r=0.05)))
    run = ck.make_fused_column_run(m, differentiable=True)
    with pytest.raises(ValueError, match="hydraulic_model.Ksat"):
        run(Y, 0.0)


def test_names_and_launch_counts():
    """The B9 run counts its forward's launches under ``B9:<mode>``; its
    name carries the inner mode's."""
    model, Y = _column()
    assert ck.make_fused_column_run(model, differentiable=True).name == "B9:B1-water"
    g1 = gct.build_model_and_state(F64, "cpu")[0]
    grid = make_function_space(g1.domain, F64, "cpu")
    lagged = dataclasses.replace(g1, coefficient_update="step")
    assert ck.make_fused_column_run(lagged, TRBDF2Soil(model=lagged, grid=grid, tridiag="pcr"),
                                    differentiable=True).name == "B9:B4-trbdf2-pcr+B2"


@pytest.mark.cuda
def test_cuda_run_refuses_a_state_that_requires_grad(cuda_device):
    """A non-differentiable run writes the state through raw pointers, where
    autograd cannot see: on CUDA tensors that require grad, in grad mode,
    it raises; under ``torch.no_grad()`` it runs."""
    model, Y, _, dt = gct.build_model_and_state(F64, cuda_device)
    run = ck.make_fused_column_run(model, dt=dt, steps_per_call=2)
    Yg = {"soil": {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}}
    with pytest.raises(ValueError, match="differentiable=True"):
        run(Yg, 0.0)
    with torch.no_grad():
        run({"soil": {k: v.clone() for k, v in Y["soil"].items()}}, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(gct.GRAD_CASES))
def test_cuda_b9_matches_the_gradient_golden(cuda_device, name):
    """On the card B9's forward is the kernel (one launch counted) and its
    gradients equal the golden's within 1e-10 of their scale."""
    golden = np.load(GOLDEN)
    ck.LAUNCHES.clear()
    loss, grads, g_t0, g_dt, _ = _b9_gradients(name, cuda_device)
    assert sum(v for k, v in ck.LAUNCHES.items() if k.startswith("B9:")) == 1
    np.testing.assert_allclose(loss, float(golden[f"{name}__loss"]), rtol=1e-12)
    for k, d in grads.items():
        ref = golden[f"{name}__g_{k}"]
        np.testing.assert_allclose(d.cpu().numpy(), ref, rtol=0, atol=1e-10 * (float(np.max(np.abs(ref))) or 1.0))
    np.testing.assert_allclose(float(g_dt), float(golden[f"{name}__g_dt"]), rtol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, c in gct.MOST_CASES.items() if c["model"] == "soil"])
def test_cuda_b9_most_soil_matches_jax_differences(cuda_device, name):
    """On the card, B9 under a MOST top: one kernel launch counted, and AD
    along the golden's directions and in dt_run equal to the differences
    of the JAX package's forward, rtol 1e-7."""
    golden = np.load(GOLDEN)
    ck.LAUNCHES.clear()
    run, loss, ad, _, g_dt = _b9_most(name, cuda_device)
    assert dict(ck.LAUNCHES) == {run.name: 1}
    np.testing.assert_allclose(loss, float(golden[f"most__{name}__loss"]), rtol=1e-12)
    np.testing.assert_allclose(ad, golden[f"most__{name}__fd"], rtol=1e-7)
    np.testing.assert_allclose(g_dt, float(golden[f"most__{name}__fd_dt"]), rtol=1e-7)
