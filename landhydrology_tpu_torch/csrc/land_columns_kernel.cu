// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6, and B7, their streamed forcing rows) with
// per-column BC kinds and geometry (MODE_COLUMNS; kernel modes B1-batched and
// B8): the surface modes of land_kernel.cu, alone and with lagged
// coefficients, and the LandModel on a water-only soil, under ForwardEuler,
// SSPRK22, SSPRK33 and SSPRK104, the stepper read at run time from the
// launch's stage table (one instance per mode runs all four).  SSPRK33 in B5
// and B6 keeps land_kernel.cu's fixed-stage instances.  The kernel, and what
// it replaces, is in land_column.cuh; the per-column grid, kinds and profile
// tables are read as column_common.cuh's load_grid, column_kind and
// load_profiles read them with MODE_COLUMNS (the JAX kernel's
// landhydrology_tpu/ops/pallas/column_kernel.py:214-249, :265, :288,
// :583-599).
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
    LAND_SURFACE_CASES(true, MODE_COLUMNS)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int land_columns_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int land_columns_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int land_columns_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
