// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6, and B7, their streamed forcing rows) under
// SSPRK33: the surface modes alone and with lagged coefficients, and the
// LandModel on a water-only soil.  The kernel, and what it replaces, is in
// land_column.cuh; land_rk_kernel.cu instantiates the same modes for the
// other explicit steppers.

#include "land_column.cuh"

namespace {

// LAND_SURFACE_CASES with SSPRK33's fixed stages, and B5 and B6 with
// per-column kinds and geometry (MODE_COLUMNS); a stepper bit selects none.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode) {
    LAND_SURFACE_CASES(false, 0)
    case MODE_MOST | MODE_COLUMNS: return launch<T, MODE_MOST | MODE_COLUMNS, false>(args, block, stream);
    case MODE_LAND | MODE_MOST | MODE_COLUMNS:
      return launch<T, MODE_LAND | MODE_MOST | MODE_COLUMNS, false>(args, block, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int land_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int land_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int land_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
