// The column-tile kernel's instances (tile_column.cuh): the coupled plain soil
// with stage coefficients and per-column BC kinds and geometry
// (MODE_COLUMNS, kernel modes B1-batched and B8), with ice (B1+kinds+B8) and
// under assume_no_ice (B1-no-ice+kinds+B8, with MODE_RHS_CAP: its stage rhs
// caps theta_l at nu - theta_i, as rhs.py does), each under ForwardEuler,
// SSPRK22, SSPRK33 and SSPRK104 from the launch's stage table: two instances
// per float type.  These modes ran before from column_kernel.cu (SSPRK33 with
// ice) and rk_columns_kernel.cu, which instantiate them no more.
//
// A source of its own: the build runs one nvcc per source and float type in
// parallel.

#include "tile_column.cuh"

// The host's mirror of the shared-memory layout (TILE_COLUMN_BYTES in
// ops/cuda/column_kernel.py) assumes these sizes.
static_assert(sizeof(Column<double>) == 320 && sizeof(Column<float>) == 168, "Column<T> changed size");

namespace {

// The stepper bits select no instance.
template <typename T>
int dispatch(const KernelArgs* args, int tc, int lanes, int smem_bytes, void* stream) {
  if (args->n_stages < 1 || args->n_stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  switch (args->mode & ~int64_t(MODE_EULER | MODE_SSPRK22 | MODE_SSPRK104)) {
    case MODE_COLUMNS: return tile_launch<T, MODE_COLUMNS>(args, tc, lanes, smem_bytes, stream);
    case MODE_NO_ICE | MODE_COLUMNS:
      return tile_launch<T, MODE_NO_ICE | MODE_COLUMNS | MODE_RHS_CAP>(args, tc, lanes, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.  `tc`
// columns per block, `lanes` level lanes, `smem_bytes` of dynamic shared
// memory: the host's tile plan.
extern "C" {

int tile_columns_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int tile_columns_kernel_f32(const KernelArgs* args, int tc, int lanes, int smem_bytes, void* stream) {
  return dispatch<float>(args, tc, lanes, smem_bytes, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int tile_columns_kernel_f64(const KernelArgs* args, int tc, int lanes, int smem_bytes, void* stream) {
  return dispatch<double>(args, tc, lanes, smem_bytes, stream);
}
#endif

}  // extern "C"
