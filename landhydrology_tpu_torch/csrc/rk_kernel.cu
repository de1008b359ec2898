// Fused multi-step soil-column kernel for the other explicit Runge-Kutta
// steppers: ForwardEuler, SSPRK22 and SSPRK104 in every plain-soil mode of
// column_kernel.cu without MODE_COLUMNS, and all four explicit steppers with
// lagged coefficients or assume_no_ice on the water-only and heat-only
// branches: 16 instances per float type.  The kernel, and what it replaces,
// is in rk_column.cuh.

#include "rk_column.cuh"

namespace {

// The stepper bits select no instance.
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  if (args->n_stages < 1 || args->n_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  switch (args->mode & ~int64_t(MODE_EULER | MODE_SSPRK22 | MODE_SSPRK104)) {
    RK_CASES(0)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int rk_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int rk_kernel_f32(const KernelArgs* args, int block, void* stream) { return dispatch<float>(args, block, stream); }
#endif

#ifndef KERNEL_F32_ONLY
int rk_kernel_f64(const KernelArgs* args, int block, void* stream) { return dispatch<double>(args, block, stream); }
#endif

}  // extern "C"
