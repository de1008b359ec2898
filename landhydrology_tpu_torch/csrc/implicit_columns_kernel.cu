// Fused multi-step soil-column kernel for the implicit steppers on the plain
// soil with per-column BC kinds and geometry (MODE_COLUMNS; kernel modes
// B1-batched and B8): BackwardEulerSoil without a step policy, the 21 policy
// instances of implicit_policy_kernel.cu (POLICY_CASES on TR-BDF2,
// BackwardEulerRichards and BackwardEulerSoil) and the 6 water-branch policy
// instances of implicit_branch_kernel.cu (WATER_POLICY_CASES), each with
// MODE_COLUMNS: 28 instances per float type.  TR-BDF2 and
// BackwardEulerRichards without a policy, on the coupled and water-only
// branches, keep implicit_kernel.cu's MODE_COLUMNS instances.  The kernel,
// and what it replaces, is in implicit_column.cuh: its rhs sweeps read each
// column's kinds, dz and centers (column_common.cuh), its Newton sweeps the
// column's dz, and the Dirichlet boost is keyed on the slot's own kind, so a
// BatchedBC column of kind DIRICHLET gets none, as imex.py boosts a plain
// Dirichlet alone (the JAX kernel's
// landhydrology_tpu/ops/pallas/column_kernel.py:214-249, :265, :288,
// :583-599; imex.py:219-517).
//
// A source of its own: the build runs one nvcc per source and float type in
// parallel.

#include "implicit_column.cuh"

namespace {

// MODE_PCR is read at run time.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode & ~int64_t(MODE_PCR)) {
    case MODE_BE_SOIL | MODE_COLUMNS: return launch<T, MODE_BE_SOIL | MODE_COLUMNS>(args, block, stream);
    POLICY_CASES(MODE_TRBDF2 | MODE_COLUMNS)
    POLICY_CASES(MODE_BE_RICHARDS | MODE_COLUMNS)
    POLICY_CASES(MODE_BE_SOIL | MODE_COLUMNS)
    WATER_POLICY_CASES(MODE_TRBDF2 | MODE_COLUMNS)
    WATER_POLICY_CASES(MODE_BE_RICHARDS | MODE_COLUMNS)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int implicit_columns_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int implicit_columns_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int implicit_columns_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
