// Fused multi-step soil-column kernel for the explicit steppers with
// per-column BC kinds and geometry (MODE_COLUMNS; kernel modes B1-batched and
// B8): 14 of the 16 modes of rk_kernel.cu (the plain soil with lagged
// coefficients, either freeze-thaw scheme, and the step policies on the
// water-only and heat-only branches: RK_OTHER_CASES) under ForwardEuler,
// SSPRK22, SSPRK33 and SSPRK104, the stepper read at run time from the
// launch's stage table (one instance per mode runs all four).  SSPRK33 in B2,
// B3-rate and B1-water keeps column_kernel.cu's fixed-stage MODE_COLUMNS
// instances; the coupled soil with stage coefficients, with ice and without
// (B1, B1-no-ice), runs in the column-tile kernel (tile_columns_kernel.cu)
// under every stepper.  The
// kernel, and what it replaces, is in rk_column.cuh; the per-column grid,
// kinds and profile tables are read as column_common.cuh's load_grid,
// column_kind and load_profiles read them with MODE_COLUMNS (the JAX kernel's
// landhydrology_tpu/ops/pallas/column_kernel.py:214-249, :265, :288,
// :583-599).  The lagged coefficients of a BatchedBC face are the step
// start's, as in every other lagged mode: the face fluxes themselves are never
// lagged (column_common.cuh's face_fluxes).
//
// A source of its own: the build runs one nvcc per source and float type in
// parallel.

#include "rk_column.cuh"

namespace {

// The stepper bits select no instance.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  if (args->n_stages < 1 || args->n_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  switch (args->mode & ~int64_t(MODE_EULER | MODE_SSPRK22 | MODE_SSPRK104)) {
    RK_OTHER_CASES(MODE_COLUMNS)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int rk_columns_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int rk_columns_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int rk_columns_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
