// Fused multi-step soil-column kernel for the implicit steppers under a MOST
// top with the step policies (kernel modes B4+B5 with B2, B3 and no ice):
// TR-BDF2, BackwardEulerSoil and BackwardEulerRichards, each with the seven
// policy settings of POLICY_CASES, 21 instances per float type.  The kernel,
// and what it replaces, is in implicit_column.cuh; the JAX body traces these
// modes as LaggedCoefficientStepper(PhaseEquilibriumStepper(stepper)) over
// the soil rhs with its MOST top
// (landhydrology_tpu/ops/pallas/column_kernel.py:142-150, :374-412).  Each
// MOST solve reads T of the top cell as the rhs of its evaluation diagnoses
// it (surface_fluxes.cuh::rhs_temperature).
//
// A source of its own beside implicit_kernel.cu, whose float64 half is the
// slowest compile of the build: the build runs one nvcc per source and float
// type in parallel.

#include "implicit_column.cuh"

namespace {

// MODE_PCR is read at run time.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    POLICY_CASES(MODE_TRBDF2 | MODE_MOST)
    POLICY_CASES(MODE_BE_RICHARDS | MODE_MOST)
    POLICY_CASES(MODE_BE_SOIL | MODE_MOST)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_most_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_most_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_most_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
