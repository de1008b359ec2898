"""The implicit steppers with the step policies on the water-only branch
(kernel modes ``B4-trbdf2-water`` and ``B4-be-richards-water`` with ``+B2``,
``-no-ice`` and ``-no-ice+B2``; ``csrc/implicit_branch_kernel.cu``) through
the kernel's plain version, against the JAX package's fused kernel in
interpret mode.

- The column: ``bench.py::build_stiff``'s stiff sand infiltration
  (water-only, a Dirichlet top at 0.267, free drainage) at nz=16 x 8, 2
  steps of dt = 5 s (20x its explicit limit) from t0 = 2 s, iters=2, Thomas
  solves, and PCR (a run-time flag of the same instances) on two cases.
  The no-ice cases start from the icy state of ``chip_smoke.py::icy_state``
  (theta_i 0.05 and vartheta_l = nu - 0.02 in the lower half): on a state
  without ice no ice equals the plain mode.
- The bar: rtol 1e-12, atol 1e-16.
- The heat-only branch keeps its refusal: JAX's fused kernel raises
  ``KeyError: 'theta_i'`` there (its implicit heat sweep reads theta_i
  from a state that holds none, ``imex.py:231``), and the port says so.

The kernel itself is held against this plain version on the card in
``chip_smoke.py`` phase 18d; the ``cuda``-marked tests skip without a GPU.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from landhydrology_tpu.domains import make_function_space as jax_grid
from landhydrology_tpu.imex import BackwardEulerRichards as JBER
from landhydrology_tpu.imex import TRBDF2Soil as JTRBDF2
from landhydrology_tpu.ops.pallas import make_fused_column_run as jax_fused
from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
from landhydrology_tpu_torch.convert import stepper_from_reference
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
from tests.test_torch_land_policies_b5 import cuda_device  # noqa: F401
from tests.test_torch_rk_branches import branch_case

NZ, NCOL, DT, STEPS, T0 = 16, 8, 5.0, 2, 2.0
POLICIES = {"+B2": {"coefficient_update": "step"}, "-no-ice": {"assume_no_ice": True},
            "-no-ice+B2": {"coefficient_update": "step", "assume_no_ice": True}}
STEPPERS = {"B4-trbdf2": JTRBDF2, "B4-be-richards": JBER}
#: (stepper, policy, tridiag): every instance with Thomas, PCR on two
CASES = ([(s, p, "thomas") for s in STEPPERS for p in POLICIES]
         + [("B4-trbdf2", "+B2", "pcr"), ("B4-be-richards", "-no-ice+B2", "pcr")])


def case_id(case):
    return run_name(*case)


def run_name(stepper, policy, tridiag):
    """``B4-trbdf2-water-no-ice-pcr+B2``: the stepper, the branch, no ice,
    PCR, lagged."""
    no_ice = "-no-ice" if "no-ice" in policy else ""
    return stepper + "-water" + no_ice + ("-pcr" if tridiag == "pcr" else "") + ("+B2" if "B2" in policy else "")


def stiff_case(stepper, policy, tridiag):
    """``(JAX model, JAX stepper, start state as numpy)``: the stiff column
    with the policy, on the icy state under no ice."""
    jm, Y, _ = bench.build_stiff(NZ, NCOL, jnp.float64)
    jm = dataclasses.replace(jm, **POLICIES[policy])
    soil = {k: np.array(v) for k, v in Y["soil"].items()}
    if "no-ice" in policy:
        soil["theta_i"][: NZ // 2] = 0.05
        soil["vartheta_l"][: NZ // 2] = float(jm.soil_param_set.nu) - 0.02
    jst = STEPPERS[stepper](model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2, tridiag=tridiag)
    return jm, jst, {"soil": soil}


def port_run(jm, jst, device):
    """``(model, stepper, fused run)`` of the port on ``device``."""
    model = model_from_reference(jm, device=device)
    st = stepper_from_reference(jst, model)
    return model, st, ck.make_fused_column_run(model, st, dt=DT, steps_per_call=STEPS, tile_cols=32)


def assert_close(got, ref):
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], np.asarray(r), rtol=1e-12, atol=1e-16, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_water_branch_policies_match_jax_fused(case):
    """The port's fused run (its plain version on the CPU) equals JAX's
    fused kernel in interpret mode; its name and source; the state moves;
    under no ice the result is not the plain mode's on the icy state."""
    jm, jst, Y = stiff_case(*case)
    ref = jax_fused(jm, jst, dt=DT, steps_per_call=STEPS, tile_cols=NCOL, interpret=True)(Y, T0)
    model, st, run = port_run(jm, jst, "cpu")
    assert run.name == run_name(*case)
    assert ck._entry(run.mode, torch.float64)[0] == "implicit_branch_kernel"
    Yt = state_from_numpy(Y, device="cpu")
    before = dict(ck.LAUNCHES)
    assert run(Yt, T0) is Yt and ck.LAUNCHES == before
    got = state_to_numpy(Yt)["soil"]
    assert_close(got, ref["soil"])
    assert np.max(np.abs(got["vartheta_l"] - Y["soil"]["vartheta_l"])) > 1e-3
    if "no-ice" in case[1]:
        plain_jm = dataclasses.replace(jm, assume_no_ice=False)
        plain_jst = dataclasses.replace(jst, model=plain_jm)
        _, _, plain = port_run(plain_jm, plain_jst, "cpu")
        Yp = state_from_numpy(Y, device="cpu")
        plain(Yp, T0)
        assert np.max(np.abs(state_to_numpy(Yp)["soil"]["vartheta_l"] - got["vartheta_l"])) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_water_branch_policies_match_plain(cuda_device, case):  # noqa: F811
    jm, jst, Y0 = stiff_case(*case)
    model, st, run = port_run(jm, jst, cuda_device)
    Y = state_from_numpy(Y0, device=cuda_device)
    plain = state_to_numpy(ck.fused_column_run_plain(model, st, DT, STEPS, Y, T0))["soil"]
    before = ck.LAUNCHES[run.name]
    run(Y, T0)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[run.name] == before + 1
    assert_close(state_to_numpy(Y)["soil"], plain)


@pytest.mark.parametrize("policy", ["B2", "no-ice", "B2-no-ice"])
def test_heat_branch_policies_stay_refused_as_in_jax(policy):
    """On the heat-only branch JAX's fused kernel cannot run TR-BDF2 with a
    policy (``KeyError: 'theta_i'`` from its heat sweep), and the port
    refuses it naming that (ROADMAP B4)."""
    jm, Y, dt, n, t0 = branch_case("heat", policy)
    jst = JTRBDF2(model=jm, grid=jax_grid(jm.domain, jnp.float64), iters=2)
    with pytest.raises(KeyError, match="theta_i"):
        jax_fused(jm, jst, dt=dt, steps_per_call=n, tile_cols=jm.domain.batch_shape[0], interpret=True)(Y, t0)
    model = model_from_reference(jm, device="cpu")
    with pytest.raises(NotImplementedError, match=r"heat-only branch.*KeyError 'theta_i'.*ROADMAP B4\)"):
        ck.make_fused_column_run(model, stepper_from_reference(jst, model))
