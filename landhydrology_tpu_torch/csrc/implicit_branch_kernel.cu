// Fused multi-step soil-column kernel for the implicit steppers with the step
// policies on the water-only branch (kernel modes B4-trbdf2-water and
// B4-be-richards-water with +B2, -no-ice and -no-ice+B2): 6 instances per
// float type.  The kernel, and what it replaces, is in implicit_column.cuh;
// the JAX body traces these modes as LaggedCoefficientStepper(stepper) over
// the water-only rhs (landhydrology_tpu/ops/pallas/column_kernel.py:142-150,
// :426-478).
//
// A source of its own beside implicit_kernel.cu, whose float64 half is the
// slowest compile of the build: the build runs one nvcc per source and float
// type in parallel.  The heat-only branch takes no policy
// (implicit_column.cuh).

#include "implicit_column.cuh"

namespace {

// TR-BDF2 and backward Euler for Richards, each lagged, without ice, or
// both (WATER_POLICY_CASES of implicit_column.cuh); MODE_PCR is read at run
// time.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    WATER_POLICY_CASES(MODE_TRBDF2)
    WATER_POLICY_CASES(MODE_BE_RICHARDS)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_branch_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_branch_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_branch_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
