// Fused multi-step column kernel with a surface exchange at the top face
// (kernel modes B5 and B6) under the step policies: rate freeze-thaw,
// equilibrium freeze-thaw or assume_no_ice, each alone or with lagged
// coefficients, on each of the five tops, and assume_no_ice on the
// LandModel over a water-only soil.  The kernel, and what it replaces,
// is in land_column.cuh; the JAX body traces these modes as
// FrozenExchangeStepper(PhaseEquilibriumStepper(SSPRK33)) over the land rhs
// (landhydrology_tpu/ops/pallas/column_kernel.py:142-143, :385-411).
//
// A source of its own beside land_kernel.cu: the MOST instances are the
// slowest to compile, and the build runs one nvcc per source and float type
// in parallel.  Every no-ice instance carries MODE_RHS_CAP: its stage rhs
// caps theta_l at nu - theta_i, as rhs.py does.

#include "land_column.cuh"

namespace {

// The five tops: B5 (the MOST soil column), B6 with a MOST top and with a
// plain top BC (-pond), each B6 with its exchange per stage or frozen per
// step; on each the six policies.
#define POLICY_CASES(S)                                                                          \
  case S | MODE_FREEZE_RATE: return launch<T, S | MODE_FREEZE_RATE>(args, block, stream);       \
  case S | MODE_FREEZE_EQ: return launch<T, S | MODE_FREEZE_EQ>(args, block, stream);           \
  case S | MODE_NO_ICE: return launch<T, S | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);  \
  case S | MODE_LAGGED | MODE_FREEZE_RATE:                                                      \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_RATE>(args, block, stream);                  \
  case S | MODE_LAGGED | MODE_FREEZE_EQ:                                                        \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_EQ>(args, block, stream);                    \
  case S | MODE_LAGGED | MODE_NO_ICE:                                                           \
    return launch<T, S | MODE_LAGGED | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);
// The LandModel on a water-only soil (a plain top) with assume_no_ice, alone
// and lagged, its exchange per stage or frozen per step; freeze-thaw needs a
// dynamic energy model.
#define WATER_CASES(S)                                                                                \
  case S | MODE_WATER | MODE_NO_ICE:                                                                  \
    return launch<T, S | MODE_WATER | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);               \
  case S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE:                                                    \
    return launch<T, S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode) {
    POLICY_CASES(MODE_MOST)
    POLICY_CASES(MODE_LAND | MODE_MOST)
    POLICY_CASES(MODE_LAND | MODE_MOST | MODE_SURFACE_STEP)
    POLICY_CASES(MODE_LAND)
    POLICY_CASES(MODE_LAND | MODE_SURFACE_STEP)
    WATER_CASES(MODE_LAND)
    WATER_CASES(MODE_LAND | MODE_SURFACE_STEP)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef POLICY_CASES
#undef WATER_CASES

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int land_policy_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int land_policy_kernel_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int land_policy_kernel_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
