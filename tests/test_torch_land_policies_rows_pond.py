"""The step policies on a LandModel under a plain top with streamed rain rows
(kernel mode B7 as a row source of the B6-pond and B6-step-pond instances of
``csrc/land_policy_kernel.cu``: ``B6-pond+B3-rate+B7`` to
``B2+B6-step-pond-no-ice+B7``) through the kernel's plain version, against
the JAX package's fused kernel in interpret mode (the cases, the rows and
the bar: ``test_torch_land_policies_rows.py``), and ``run_forced`` with a
policy on the fused engine against the eager one.  The kernel is held
against this plain version on the card in ``chip_smoke.py`` phase 17a.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import numpy as np
import pytest

from landhydrology_tpu_torch.timestepping import SSPRK33
from tests.test_torch_land_policies_b5 import case_id, cases, cuda_device  # noqa: F401
from tests.test_torch_land_policies_rows import check_rows_case, cuda_rows_match_plain


@pytest.mark.parametrize("case", cases(("B6-pond", "B6-step-pond")), ids=case_id)
def test_pond_policy_instances_with_rain_rows_match_jax_fused(case):
    check_rows_case(*case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", cases(("B6-pond", "B6-step-pond")), ids=case_id)
def test_cuda_pond_policy_instances_with_rain_rows_match_plain(cuda_device, case):  # noqa: F811
    cuda_rows_match_plain(cuda_device, *case)
    if case[1] == "-no-ice":
        cuda_rows_match_plain(cuda_device, *case, icy=True)


@pytest.mark.parametrize("case", [("B2+B6-step", "+B3-rate"), ("B5", "+B3-eq"), ("B6-pond", "-no-ice")])
def test_run_forced_with_a_policy_equals_the_eager_engine(tmp_path, case):
    """``run_forced(..., engine="fused")`` on a LandModel or a MOST soil with
    a step policy, its rows from a file in windows of 4 (the plain version on
    the CPU) == the eager engine at rtol 1e-12: the policies wrap the
    stepper per row as they do for the runs without rows."""
    from landhydrology_tpu_torch.convert import model_from_reference, state_from_numpy, state_to_numpy
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.runtime import ForcingReader, run_forced, write_forcing
    from tests.test_torch_land_policies_b5 import DT, T0, cold_state, jax_model
    from tests.test_torch_land_policies_rows import forcing_rows

    top, policy = case
    lagged = top.startswith("B2+")
    jm = jax_model(top.removeprefix("B2+"), policy, lagged)
    model = model_from_reference(jm, device="cpu")
    Y = state_from_numpy(cold_state(jm), device="cpu")
    soil = getattr(model, "soil", model)
    Ya = {"zc": make_function_space(soil.domain, soil.float_dtype, "cpu").zc, "soil": {}}
    rows = forcing_rows(top.removeprefix("B2+"), 6)
    path = str(tmp_path / "forcing.bin")
    write_forcing(path, T0 + np.arange(6) * DT, rows)
    out = {}
    for engine in ("torch", "fused"):
        with ForcingReader(path) as reader:
            out[engine], _ = run_forced(model, Y, Ya, reader, SSPRK33(), dt=DT, t0=T0, window=4, engine=engine,
                                        steps_per_call=2)
    got, ref = state_to_numpy(out["fused"]), state_to_numpy(out["torch"])
    for group, fields in ref.items():
        for k, v in fields.items():
            np.testing.assert_allclose(got[group][k], v, rtol=1e-12, atol=1e-16, err_msg=f"{group}/{k}")
    changed = np.abs(ref["soil"]["theta_i"] - state_to_numpy(Y)["soil"]["theta_i"]).max()
    assert (changed > 1e-6) == (policy != "-no-ice")
