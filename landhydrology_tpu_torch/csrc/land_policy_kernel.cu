// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6) under the step policies, with SSPRK33: rate
// freeze-thaw, equilibrium freeze-thaw or assume_no_ice, each alone or with
// lagged coefficients, on each of the five tops, and assume_no_ice on the
// LandModel over a water-only soil (LAND_ALL_POLICY_CASES).  The kernel,
// and what it replaces, is in land_column.cuh; the JAX body traces these
// modes as FrozenExchangeStepper(PhaseEquilibriumStepper(SSPRK33)) over the
// land rhs (landhydrology_tpu/ops/pallas/column_kernel.py:142-143,
// :385-411).  land_policy_rk_kernel.cu instantiates the same modes for the
// other explicit steppers.
//
// A source of its own beside land_kernel.cu: the MOST instances are the
// slowest to compile, and the build runs one nvcc per source and float type
// in parallel.

#include "land_column.cuh"

namespace {

// A stepper bit selects none.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode) {
    LAND_ALL_POLICY_CASES(false, 0)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int land_policy_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int land_policy_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int land_policy_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
