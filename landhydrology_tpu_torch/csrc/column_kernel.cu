// Fused multi-step soil-column kernel: SSPRK33 steps of the soil tendency,
// one thread per column.
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// in its explicit SSPRK33 modes: the branches of
// landhydrology_tpu/models/soil/rhs.py with the boundary.py flux conversion,
// advanced by timestepping.py::SSPRK33, `n_steps` steps per launch, in place.
// The mode word (enum Mode in column_common.cuh, a template parameter)
// selects, at compile time:
//   MODE_WATER        the water-only branch (PrescribedTemperatureModel):
//                     Richards only, T from the prescribed profile's rows;
//   MODE_HEAT         the heat-only branch (PrescribedHydrologyModel):
//                     conduction only, vartheta_l and theta_i from the
//                     profiles' rows; coupled without either;
//   MODE_LAGGED       kernel B2, models/soil/lagged.py: K, kappa, rho_c_s,
//                     1/rho_c_s and rho_e_int_l K once per step from the
//                     step's start state, held across the three stages;
//   MODE_FREEZE_RATE  kernel B3, freeze_thaw.py::phase_change_sources in
//                     every stage (rhs.py coupled branch);
//   MODE_FREEZE_EQ    kernel B3, freeze_thaw.py::equilibrium_phase_projection
//                     of every cell after the third stage;
//   MODE_NO_ICE       SoilModel(assume_no_ice=True): the ice branches of the
//                     closures drop out;
//   MODE_COLUMNS      per-column BC kinds (B1-batched) and per-column
//                     geometry and profiles (B8), read at run time (B1's
//                     is the column-tile kernel's, tile_columns_kernel.cu).
// Per step the order is: coefficients, three stages, projection.
//
// Bound: transcendental throughput.  Each cell evaluates about ten exp/log
// per stage (van Genuchten psi and K, the Kersten number, kappa_sat), and a
// stage moves only six values per cell (three in, three out).  So the
// design spends nothing on data staging: the state, the two SSPRK33 stage
// buffers and the lagged coefficients stay in global memory.  Loads at
// k*ncol + col are coalesced across a warp.  Per-column constants are loaded
// once per launch, and a sliding window over the levels (bottom to top)
// keeps the previous center's fields in registers, so each stage is a single
// pass.  The lagged mode moves the closure sweep into one pass per step and
// leaves each stage psi (two exp/log pairs) and the boundary cells.  The
// equilibrium projection costs n_iter (default 60) bisection rounds of two
// pow per cell and step; it is the bulk of that mode's time.

#include "ssprk33.cuh"

namespace {

template <typename T, int M>
__global__ void ssprk33_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  const Column<T> c = load_column<T>(a, col, eps, tiny);
  const T dt = T(a.dt);
  const Grid<T, M> g = load_grid<T, M>(a, col);

  const int64_t n = a.nz * a.ncol;
  T* scratch = static_cast<T*>(a.scratch);
  Fields<T> Y{static_cast<T*>(a.vartheta_l), static_cast<T*>(a.theta_i),
              static_cast<T*>(a.rho_e_int)};
  Fields<T> A{scratch, scratch + n, scratch + 2 * n};
  Fields<T> B{scratch + 3 * n, scratch + 4 * n, scratch + 5 * n};
  Coefs<T> coef{scratch + 6 * n, scratch + 7 * n, scratch + 8 * n,
                scratch + 9 * n, scratch + 10 * n};

  for (int64_t step = 0; step < a.n_steps; ++step) {
    if (Modes<M>::lagged) coefficients<T, M>(c, a, col, Y.vl, Y.ti, Y.re, coef);
    for (int s = 0; s < 3; ++s) {
      const int64_t row = a.rows_per_step * step + s;
      T bc_val[kNumBC];
      load_bc(a, row, col, bc_val);
      const Profiles<T, M> prof = load_profiles<T, M>(a, row, col);
      if (s == 0) stage<T, M>(c, a, col, Y, Y, A, 0, bc_val, prof, g, dt, coef);
      if (s == 1) stage<T, M>(c, a, col, A, Y, B, 1, bc_val, prof, g, dt, coef);
      if (s == 2) stage<T, M>(c, a, col, B, Y, Y, 2, bc_val, prof, g, dt, coef);
    }
  }
}

template <typename T, int M>
int launch(const KernelArgs* args, int block, void* stream) {
  const int64_t grid = (args->ncol + block - 1) / block;
  ssprk33_column_kernel<T, M><<<static_cast<unsigned>(grid), block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

// The mode word selects a template instance; assume_no_ice excludes
// freeze-thaw, the two freeze-thaw schemes exclude each other, and the
// water-only and heat-only branches run with stage coefficients alone.
// B1-no-ice carries MODE_RHS_CAP: its stage rhs caps theta_l at nu -
// theta_i, as rhs.py does (B2-no-ice takes its closures from lagged.py's
// sweep, which caps at nu).
// MODE_COLUMNS joins B2, B3-rate and B1-water (B1 and B1-no-ice take it in
// tile_columns_kernel.cu, the other modes in rk_columns_kernel.cu, both from
// the stage table).
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode) {
    case 0: return launch<T, 0>(args, block, stream);
    case MODE_LAGGED: return launch<T, MODE_LAGGED>(args, block, stream);
    case MODE_NO_ICE: return launch<T, MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);
    case MODE_LAGGED | MODE_NO_ICE:
      return launch<T, MODE_LAGGED | MODE_NO_ICE>(args, block, stream);
    case MODE_FREEZE_RATE: return launch<T, MODE_FREEZE_RATE>(args, block, stream);
    case MODE_LAGGED | MODE_FREEZE_RATE:
      return launch<T, MODE_LAGGED | MODE_FREEZE_RATE>(args, block, stream);
    case MODE_FREEZE_EQ: return launch<T, MODE_FREEZE_EQ>(args, block, stream);
    case MODE_LAGGED | MODE_FREEZE_EQ:
      return launch<T, MODE_LAGGED | MODE_FREEZE_EQ>(args, block, stream);
    case MODE_WATER: return launch<T, MODE_WATER>(args, block, stream);
    case MODE_HEAT: return launch<T, MODE_HEAT>(args, block, stream);
    case MODE_LAGGED | MODE_COLUMNS: return launch<T, MODE_LAGGED | MODE_COLUMNS>(args, block, stream);
    case MODE_FREEZE_RATE | MODE_COLUMNS:
      return launch<T, MODE_FREEZE_RATE | MODE_COLUMNS>(args, block, stream);
    case MODE_WATER | MODE_COLUMNS: return launch<T, MODE_WATER | MODE_COLUMNS>(args, block, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Built once per float type: -DKERNEL_F32_ONLY or -DKERNEL_F64_ONLY keeps
// one entry point, and with it that type's template instances alone.
extern "C" {

int column_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

#ifndef KERNEL_F64_ONLY
int column_kernel_ssprk33_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}
#endif

#ifndef KERNEL_F32_ONLY
int column_kernel_ssprk33_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}
#endif

}  // extern "C"
