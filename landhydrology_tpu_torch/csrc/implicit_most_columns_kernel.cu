// Fused multi-step soil-column kernel for the implicit steppers under a MOST
// top with per-column BC kinds and geometry (MODE_MOST | MODE_COLUMNS; kernel
// modes B4+B5 with B1-batched and B8): TR-BDF2, BackwardEulerRichards and
// BackwardEulerSoil without a step policy, and each with the seven policy
// settings of POLICY_CASES, 24 instances per float type.  The kernel, and
// what it replaces, is in implicit_column.cuh; the JAX body traces these
// modes as LaggedCoefficientStepper(PhaseEquilibriumStepper(stepper)) over
// the soil rhs with its MOST top
// (landhydrology_tpu/ops/pallas/column_kernel.py:142-150, :374-412), on each
// column's kinds and grid (:214-249, :265, :288, :583-599;
// boundary.py:371-408).  The MOST solve reads no geometry: each sweep reads
// its column's dz and centers through the grid the kernel loads once per
// column, the bottom faces the column's kinds, and the top faces the
// exchange's fluxes.  The Dirichlet boost is keyed on the slot's own kind, so
// a BatchedBC bottom column of kind DIRICHLET gets none, as imex.py boosts a
// plain Dirichlet alone.  Forcing rows (B7) are a run-time row source and add
// no instance.
//
// A source of its own beside implicit_most_kernel.cu: the build runs one nvcc
// per source and float type in parallel.

#include "implicit_column.cuh"

namespace {

// MODE_PCR is read at run time.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    case MODE_TRBDF2 | MODE_MOST | MODE_COLUMNS:
      return launch<T, MODE_TRBDF2 | MODE_MOST | MODE_COLUMNS>(args, block, stream);
    case MODE_BE_RICHARDS | MODE_MOST | MODE_COLUMNS:
      return launch<T, MODE_BE_RICHARDS | MODE_MOST | MODE_COLUMNS>(args, block, stream);
    case MODE_BE_SOIL | MODE_MOST | MODE_COLUMNS:
      return launch<T, MODE_BE_SOIL | MODE_MOST | MODE_COLUMNS>(args, block, stream);
    POLICY_CASES(MODE_TRBDF2 | MODE_MOST | MODE_COLUMNS)
    POLICY_CASES(MODE_BE_RICHARDS | MODE_MOST | MODE_COLUMNS)
    POLICY_CASES(MODE_BE_SOIL | MODE_MOST | MODE_COLUMNS)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_most_columns_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_most_columns_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_most_columns_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
