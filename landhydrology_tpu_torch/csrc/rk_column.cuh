// The fused multi-step soil-column kernel of the explicit steppers' stage
// table, and its launch: ForwardEuler, SSPRK22 and SSPRK104
// (timestepping.py), one thread per column, and SSPRK33 where
// column_kernel.cu has no instance (lagged coefficients or assume_no_ice on
// the water-only and heat-only branches, and the modes with MODE_COLUMNS but
// B1, B2, B3-rate and B1-water).
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// with those steppers traced in its body (`stepper_i.step`): `n_steps` steps
// per launch, in place.  The template's mode word selects the branch and the
// step policies as in column_kernel.cu (MODE_WATER, MODE_HEAT, MODE_LAGGED,
// MODE_FREEZE_RATE, MODE_FREEZE_EQ, MODE_NO_ICE); the stepper is read at run
// time from the launch's stage table (KernelArgs::stage_*, built on the host
// by ops/cuda/column_kernel.py::stage_table), so one instance per mode runs
// all four steppers.  Per step the order is: coefficients (from the step's
// start state, held across every stage), the stages, the projection after
// the last stage.
//
// Each stage is one rhs_sweep of column_common.cuh over the register it
// reads, writing the register the table names (column_common.cuh's
// table_stage, which land_column.cuh's surface modes share):
//   ForwardEuler  Y <- Y + dt f(Y)                       (in place)
//   SSPRK22       A <- Y + dt f(Y); Y <- Y/2 + (A + dt f(A))/2
//   SSPRK33       A, B, Y as in ssprk33.cuh
//   SSPRK104      A <- Y + dt/6 f(Y); A <- A + dt/6 f(A) three times;
//                 the fifth stage also forms q2 = Y/25 + 9/25 A into B and
//                 A <- 15 B - 5 A; four more A <- A + dt/6 f(A); then
//                 Y <- (B + 3/5 A) + dt/10 f(A)
// so the state itself is SSPRK104's third register: it is read until the
// fifth stage and written only by the last, and the two scratch states of
// SSPRK33 hold q1 and q2.  The stage times of the BC and profile tables come from the
// stepper's stage_times on the host, in the model dtype, and so do the
// coefficients h (dt, dt/6, dt/10): the kernel computes no time.
//
// Every instance carries MODE_RHS_CAP: under assume_no_ice the stage rhs
// caps theta_l at nu - theta_i for the closures, as rhs.py's coupled branch
// does (column_kernel.cu's B1-no-ice caps it at nu; ROADMAP C).
//
// Two sources instantiate it: rk_kernel.cu the 16 modes of RK_CASES(0), and
// rk_columns_kernel.cu the 14 of RK_OTHER_CASES with MODE_COLUMNS (per-column
// BC kinds and geometry, kernel modes B1-batched and B8: column_common.cuh's
// load_grid, column_kind and load_profiles read them; B1 and B1-no-ice with
// MODE_COLUMNS are the column-tile kernel's, tile_columns_kernel.cu).

#pragma once

#include "column_common.cuh"

namespace {

template <typename T, int M>
__global__ void rk_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  const Column<T> c = load_column<T>(a, col, eps, tiny);
  const Grid<T, M> g = load_grid<T, M>(a, col);

  const int64_t n = a.nz * a.ncol;
  T* scratch = static_cast<T*>(a.scratch);
  const Fields<T> reg[3] = {
      {static_cast<T*>(a.vartheta_l), static_cast<T*>(a.theta_i), static_cast<T*>(a.rho_e_int)},
      {scratch, scratch + n, scratch + 2 * n},
      {scratch + 3 * n, scratch + 4 * n, scratch + 5 * n}};
  Coefs<T> coef{scratch + 6 * n, scratch + 7 * n, scratch + 8 * n, scratch + 9 * n, scratch + 10 * n};

  for (int64_t step = 0; step < a.n_steps; ++step) {
    if (Modes<M>::lagged) {
      const Profiles<T, M> prof = load_profiles<T, M>(a, a.rows_per_step * step, col);
      branch_coefficients<T, M>(c, a, col, reg[0], prof, coef);
    }
    for (int s = 0; s < a.n_stages; ++s) {
      const int64_t row = a.rows_per_step * step + s;
      T bc_val[kNumBC];
      load_bc(a, row, col, bc_val);
      const Profiles<T, M> prof = load_profiles<T, M>(a, row, col);
      table_stage<T, M>(c, a, col, reg, load_stage<T>(a, s), s == a.n_stages - 1, bc_val, prof, g, coef);
    }
  }
}

template <typename T, int M>
int launch(const KernelArgs* args, int block, void* stream) {
  const int64_t grid = (args->ncol + block - 1) / block;
  rk_column_kernel<T, M | MODE_RHS_CAP><<<static_cast<unsigned>(grid), block, 0, static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

// The plain-soil modes of column_kernel.cu and the step policies on the
// branches, with the extra mode bit C (0, or MODE_COLUMNS: per-column BC
// kinds and geometry): stage or lagged coefficients, each alone, with no ice,
// or with either freeze-thaw scheme, on the coupled plain soil, and lagged
// coefficients and assume_no_ice (alone and together) on the water-only and
// heat-only branches, each also without either.  The stepper bits select no
// instance.  RK_OTHER_CASES leaves out the coupled soil with stage
// coefficients, with ice and without: with MODE_COLUMNS those two are the
// column-tile kernel's (tile_columns_kernel.cu).
#define RK_CASES(C)                                                                                           \
  case C: return launch<T, C>(args, block, stream);                                                          \
  case MODE_NO_ICE | C: return launch<T, MODE_NO_ICE | C>(args, block, stream);                              \
  RK_OTHER_CASES(C)
#define RK_OTHER_CASES(C)                                                                                     \
  case MODE_LAGGED | C: return launch<T, MODE_LAGGED | C>(args, block, stream);                              \
  case MODE_LAGGED | MODE_NO_ICE | C: return launch<T, MODE_LAGGED | MODE_NO_ICE | C>(args, block, stream);  \
  case MODE_FREEZE_RATE | C: return launch<T, MODE_FREEZE_RATE | C>(args, block, stream);                    \
  case MODE_LAGGED | MODE_FREEZE_RATE | C:                                                                   \
    return launch<T, MODE_LAGGED | MODE_FREEZE_RATE | C>(args, block, stream);                               \
  case MODE_FREEZE_EQ | C: return launch<T, MODE_FREEZE_EQ | C>(args, block, stream);                        \
  case MODE_LAGGED | MODE_FREEZE_EQ | C:                                                                     \
    return launch<T, MODE_LAGGED | MODE_FREEZE_EQ | C>(args, block, stream);                                 \
  RK_BRANCH_CASES(MODE_WATER | C)                                                                            \
  RK_BRANCH_CASES(MODE_HEAT | C)
#define RK_BRANCH_CASES(B)                                                                                    \
  case B: return launch<T, B>(args, block, stream);                                                          \
  case B | MODE_LAGGED: return launch<T, B | MODE_LAGGED>(args, block, stream);                              \
  case B | MODE_NO_ICE: return launch<T, B | MODE_NO_ICE>(args, block, stream);                              \
  case B | MODE_LAGGED | MODE_NO_ICE: return launch<T, B | MODE_LAGGED | MODE_NO_ICE>(args, block, stream);

}  // namespace
