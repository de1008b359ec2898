// Fused multi-step soil-column kernel for the implicit steppers with the step
// policies on the coupled plain soil (kernel modes B4 with B2, B3 and no ice:
// B4-trbdf2+B2, B4-be-soil+B3-rate, B4-be-richards-no-ice+B2, ...): TR-BDF2,
// BackwardEulerRichards and BackwardEulerSoil, each with the seven policy
// settings of POLICY_CASES, 21 instances per float type.  The kernel, and
// what it replaces, is in implicit_column.cuh; the JAX body traces these
// modes as LaggedCoefficientStepper(PhaseEquilibriumStepper(stepper)) over
// the soil rhs (landhydrology_tpu/ops/pallas/column_kernel.py:142-150,
// :426-478).
//
// A source of its own beside implicit_kernel.cu, which held these instances
// until its float64 half set the build's time: the build runs one nvcc per
// source and float type in parallel.

#include "implicit_column.cuh"

namespace {

// MODE_PCR is read at run time.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    POLICY_CASES(MODE_TRBDF2)
    POLICY_CASES(MODE_BE_RICHARDS)
    POLICY_CASES(MODE_BE_SOIL)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_policy_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_policy_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_policy_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
