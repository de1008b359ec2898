// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6) under the step policies, with ForwardEuler,
// SSPRK22 and SSPRK104: land_policy_kernel.cu's modes, the stepper read at
// run time from the launch's stage table (one instance per mode runs all
// three).  The kernel, and what it replaces, is in land_column.cuh; the JAX
// body traces these modes as FrozenExchangeStepper(PhaseEquilibriumStepper(
// stepper)) over the land rhs (landhydrology_tpu/ops/pallas/
// column_kernel.py:142-143, :385-411).
//
// A source of its own: the build runs one nvcc per source and float type in
// parallel.

#include "land_column.cuh"

namespace {

// The stepper bits select no instance.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  if (args->n_stages < 1 || args->n_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  switch (args->mode & ~int64_t(MODE_EULER | MODE_SSPRK22 | MODE_SSPRK104)) {
    LAND_ALL_POLICY_CASES(true, 0)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int land_policy_rk_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int land_policy_rk_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int land_policy_rk_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
