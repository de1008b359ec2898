// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6, and B7, their streamed forcing rows): the surface
// modes alone and with lagged coefficients, and the LandModel on a
// water-only soil.  The kernel, and what it replaces, is in land_column.cuh.

#include "land_column.cuh"

namespace {

// B5 and B2+B5 on a soil column; B6 (with MOST) and B6-pond (a plain top
// BC), each with or without the frozen exchange and lagged coefficients;
// B6-pond on a water-only soil (H) likewise; B5 and B6 with per-column kinds
// and geometry (MODE_COLUMNS).
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  constexpr int64_t L = MODE_LAND, S = MODE_SURFACE_STEP, G = MODE_LAGGED, W = MODE_MOST, C = MODE_COLUMNS;
  constexpr int64_t H = MODE_WATER;
  switch (args->mode) {
    case W: return launch<T, W>(args, block, stream);
    case W | G: return launch<T, W | G>(args, block, stream);
    case L | W: return launch<T, L | W>(args, block, stream);
    case L | W | S: return launch<T, L | W | S>(args, block, stream);
    case L | W | G: return launch<T, L | W | G>(args, block, stream);
    case L | W | G | S: return launch<T, L | W | G | S>(args, block, stream);
    case L: return launch<T, L>(args, block, stream);
    case L | S: return launch<T, L | S>(args, block, stream);
    case L | G: return launch<T, L | G>(args, block, stream);
    case L | G | S: return launch<T, L | G | S>(args, block, stream);
    case L | H: return launch<T, L | H>(args, block, stream);
    case L | S | H: return launch<T, L | S | H>(args, block, stream);
    case L | G | H: return launch<T, L | G | H>(args, block, stream);
    case L | G | S | H: return launch<T, L | G | S | H>(args, block, stream);
    case W | C: return launch<T, W | C>(args, block, stream);
    case L | W | C: return launch<T, L | W | C>(args, block, stream);
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
