"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes."""

from landhydrology_tpu_torch.ops.cuda.column_kernel import (
    fused_column_run_plain,
    make_fused_column_run,
)

__all__ = ["fused_column_run_plain", "make_fused_column_run"]
