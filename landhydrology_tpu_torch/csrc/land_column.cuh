// The fused multi-step column kernel with a surface exchange at the top
// face: steps of any explicit stepper, one thread per column (kernel modes
// B5 and B6, and B7, their streamed forcing rows), and its launch.  The
// surface modes alone and with lagged coefficients, and the LandModel on a
// water-only soil under its plain top (MODE_WATER), are instantiated by
// land_kernel.cu (SSPRK33) and land_rk_kernel.cu (the other steppers); the
// surface modes with freeze-thaw or assume_no_ice (each alone or with lagged
// coefficients), and the water-only LandModel with assume_no_ice, by
// land_policy_kernel.cu and land_policy_rk_kernel.cu.  With per-column BC
// kinds and geometry (MODE_COLUMNS) every one of these 48 modes runs the
// stage table, all four explicit steppers, from land_columns_kernel.cu and
// land_policy_columns_kernel.cu; land_kernel.cu keeps B5 and B6 with
// MODE_COLUMNS under SSPRK33's fixed stages.
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// where its body traces a MOST top face (B5: PrescribedAtmosForcing, the
// rhs through boundary.py::boundary_fluxes) or the LandModel (B6:
// models/land.py, the pond height h_s one more per-column in/out value,
// column_kernel.py:111-137, :385-411, :613-621), with whichever explicit
// stepper the body traces (`stepper_i.step`, :478).  kTable false: SSPRK33's
// three fixed stages (ssprk33.cuh).  kTable true: ForwardEuler, SSPRK22 or
// SSPRK104 (SSPRK33 too, if asked), read at run time from the launch's
// stage table (KernelArgs::stage_*, column_common.cuh's Stage and
// table_stage; built on the host by ops/cuda/column_kernel.py::stage_table),
// so one instance per mode runs all three.  The soil fields go through
// table_stage over the three registers (the state, A and B); the pond h_s
// follows the same table as a per-thread value in three registers (h, h1,
// h2), with column_common.cuh's stage_value, so it rounds as the eager step
// does, SSPRK104's split stage (which also writes q2) included.  SSPRK33
// keeps its fixed stages: on an H100 the table instance holds 10-45% more
// registers and runs SSPRK33 4-8% slower in float64 and 1.15-1.9x slower in
// float32.  The mode word selects:
//   MODE_MOST          the top fluxes from a MOST solve (surface_fluxes.cuh);
//   MODE_LAND          the pond store: the soil's top water flux is
//                      -infiltration + evap_soil, its top energy flux the
//                      MOST heat flux (with MODE_MOST) or its own top energy
//                      BC, and dh_s/dt = P - infiltration - evap_pond is
//                      stepped with the soil's stages;
//   MODE_SURFACE_STEP  LandModel(surface_update="step"): the exchange is
//                      evaluated once per step from the step's start state
//                      (its first BC row) and held across all the stages
//                      (FrozenExchangeStepper, land.py:553-620);
//   MODE_LAGGED        coefficient_update="step" (kernel B2);
//   MODE_FREEZE_RATE   FreezeThaw: the rate sources in every stage's soil rhs
//                      (with MODE_LAGGED through the lagged rho_c_s);
//   MODE_FREEZE_EQ     EquilibriumFreezeThaw: the projection of the soil
//                      fields on the step's last stage, so a frozen
//                      exchange reads the projected state, and the pond is
//                      left alone, as freeze_thaw.py keeps it;
//   MODE_NO_ICE        assume_no_ice in the soil rhs, always with
//                      MODE_RHS_CAP (theta_l capped at nu - theta_i, as
//                      rhs.py caps it);
//   MODE_WATER         the LandModel on a water-only soil
//                      (PrescribedTemperatureModel, a plain top): Richards
//                      alone, T from the prescribed profile in the soil rhs
//                      and its lagged K (the profile at the step's start), no
//                      rho_e_int; the exchange sees 288 K (surface_exchange),
//                      as land.py does in a fused run, whose auxiliary state
//                      carries no T;
//   MODE_COLUMNS       per-column BC kinds (B1-batched) and geometry (B8):
//                      the column's own dz, so also the pond's top half-cell
//                      dzb, centers and prescribed profiles (load_grid,
//                      load_profiles), and the kind of each BC_BATCHED slot
//                      the exchange does not replace (column_kind).
// B7 (column_kernel.py:413-475, :512-575, forcing_fields and
// forcing_time_grid) is a row source, not a mode: the forced atmosphere
// fields and the rain rate are read at the step's forcing row (the step, or
// the time-indexed row of the step's start time) for all its stages and
// for a frozen exchange; the others keep their stage rows (rows_per_step =
// the stepper's stages).  The rows stay in
// global memory (no copy per launch: the pointers carry the launch's chunk
// offset), read once per column and exchange.
// B5 reads T of the top cell as the soil rhs has it (rhs_temperature:
// through the lagged heat capacity in B2+B5; under assume_no_ice without the
// ice terms, as rhs.py's no-ice closures diagnose it); B6's exchange
// diagnoses T of the top slab in full, as land.py does, assume_no_ice or
// not.  The exchange reads only the top cell, and its
// rates replace the top face's BC values of the stage's rhs sweep.
//
// Per step the order is: lagged coefficients at the step's start, the
// frozen exchange, then per stage the exchange (or the frozen one), the
// pond's stage value and the soil's stage sweep.
//
// Bound: one MOST solve per column and stage (per step with
// MODE_SURFACE_STEP) costs about 20 x 4 evaluations of the consistency
// equation in float64 (4 x 8 + 4 in float32), each two psi differences of
// eight square roots, five divisions and two logs; at nz = 64 that is of
// the order of the soil sweep's transcendental work.  The design keeps the
// column's exchange in registers and the pond's stage values too (one
// thread owns the column), and stops each multisection round at the first
// probe whose sign flips.

#pragma once

#include "ssprk33.cuh"
#include "surface_fluxes.cuh"

namespace {

template <typename T, int M, bool kTable>
__global__ void land_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  const Column<T> c = load_column<T>(a, col, eps, tiny);
  const T dt = T(a.dt);
  const Grid<T, M> g = load_grid<T, M>(a, col);
  const T dzb = g.dz / T(2);

  const int64_t n = a.nz * a.ncol;
  const int64_t top = (a.nz - 1) * a.ncol + col;
  T* scratch = static_cast<T*>(a.scratch);
  Fields<T> Y{static_cast<T*>(a.vartheta_l), static_cast<T*>(a.theta_i),
              static_cast<T*>(a.rho_e_int)};
  Fields<T> A{scratch, scratch + n, scratch + 2 * n};
  Fields<T> B{scratch + 3 * n, scratch + 4 * n, scratch + 5 * n};
  Coefs<T> coef{scratch + 6 * n, scratch + 7 * n, scratch + 8 * n, scratch + 9 * n,
                Modes<M>::rate ? scratch + 10 * n : nullptr};

  constexpr bool land = Modes<M>::land, water = Modes<M>::water;
  T* h_s = static_cast<T*>(a.h_s);
  T h = land ? h_s[col] : T(0);
  const T tau_pond = land ? surface_value<T>(a, S_TAU_POND, 0, col) : T(1);
  const T h_evap = land ? surface_value<T>(a, S_H_EVAP_SMOOTHING, 0, col) : T(1);

  const T t0 = T(a.t0), t_f0 = T(a.t_forcing0), inv_dt_f = T(a.inv_dt_forcing);
  [[maybe_unused]] T h1 = T(0), h2 = T(0);  // the table's pond in the registers A and B
  for (int64_t step = 0; step < a.n_steps; ++step) {
    if constexpr (Modes<M>::lagged && water) {  // K alone, at the profile's T of the step's start
      branch_coefficients<T, M>(c, a, col, Y, load_profiles<T, M>(a, a.rows_per_step * step, col), coef);
    } else if (Modes<M>::lagged) {
      coefficients<T, M>(c, a, col, Y.vl, Y.ti, Y.re, coef);
    }
    const int64_t row0 = a.rows_per_step * step;
    const int64_t frow = forcing_row<T>(a.frow_mode, step, t0, dt, t_f0, inv_dt_f, a.n_frows);
    Exchange<T> frozen{};
    if (land && Modes<M>::surface_step) {
      frozen = surface_exchange<T, M>(c, a, row0, frow, col, Y.vl[top], Y.ti[top], water ? T(0) : Y.re[top], h,
                                      dzb, tau_pond, h_evap);
    }
    if constexpr (kTable) {  // the launch's stage table: registers 0, 1, 2 are Y, A, B
      const Fields<T> reg[3] = {Y, A, B};
      for (int s = 0; s < a.n_stages; ++s) {
        const Stage<T> st = load_stage<T>(a, s);
        const int64_t row = row0 + s;
        const Fields<T> u = reg[st.in];
        T bc_val[kNumBC];
        load_bc(a, row, col, bc_val);
        const T vl = u.vl[top], ti = u.ti[top], re = water ? T(0) : u.re[top];
        if (land) {
          const T h_u = st.in == 0 ? h : (st.in == 1 ? h1 : h2);
          const Exchange<T> ex = Modes<M>::surface_step
                                     ? frozen
                                     : surface_exchange<T, M>(c, a, row, frow, col, vl, ti, re, h_u,
                                                              dzb, tau_pond, h_evap);
          bc_val[BC_TOP_HYDROLOGY] = -ex.infiltration + ex.evap_soil;
          if (Modes<M>::most) bc_val[BC_TOP_ENERGY] = ex.heat_flux;
          // the pond's stage value, read before the registers it writes
          T h_aux = st.aux == 0 ? h : (st.aux == 1 ? h1 : h2);
          const T h_y = h;
          const T n_h = stage_value(st, h_u, ex.P - ex.infiltration - ex.evap_pond, &h_y, &h_aux);
          if (st.kind == STAGE_SPLIT) {  // q2 into the auxiliary register
            if (st.aux == 0) h = h_aux;
            else if (st.aux == 1) h1 = h_aux;
            else h2 = h_aux;
          }
          if (st.out == 0) h = n_h;
          else if (st.out == 1) h1 = n_h;
          else h2 = n_h;
        } else {  // B5: the soil rhs's T of the top cell
          const T temp = rhs_temperature<T, M>(c, coef, top, vl, ti, re);
          turbulent_fluxes(c, a, load_atmos<T>(a, row, frow, col), vl, ti, temp,
                           &bc_val[BC_TOP_ENERGY], &bc_val[BC_TOP_HYDROLOGY]);
        }
        const Profiles<T, M> prof = load_profiles<T, M>(a, row, col);
        table_stage<T, M>(c, a, col, reg, st, s == a.n_stages - 1, bc_val, prof, g, coef);
      }
    } else {  // SSPRK33's fixed stages
      T h_a = T(0), h_b = T(0);  // the pond after stages 0 and 1
      for (int s = 0; s < 3; ++s) {
        const int64_t row = row0 + s;
        const Fields<T> u = s == 0 ? Y : (s == 1 ? A : B);
        const Fields<T> out = s == 0 ? A : (s == 1 ? B : Y);
        T bc_val[kNumBC];
        load_bc(a, row, col, bc_val);
        const T vl = u.vl[top], ti = u.ti[top], re = water ? T(0) : u.re[top];
        if (land) {
          const T h_u = s == 0 ? h : (s == 1 ? h_a : h_b);
          const Exchange<T> ex = Modes<M>::surface_step
                                     ? frozen
                                     : surface_exchange<T, M>(c, a, row, frow, col, vl, ti, re, h_u,
                                                              dzb, tau_pond, h_evap);
          bc_val[BC_TOP_HYDROLOGY] = -ex.infiltration + ex.evap_soil;
          if (Modes<M>::most) bc_val[BC_TOP_ENERGY] = ex.heat_flux;
          const T n_h = h_u + dt * (ex.P - ex.infiltration - ex.evap_pond);
          if (s == 0) h_a = n_h;
          if (s == 1) h_b = T(0.75) * h + T(0.25) * n_h;
          if (s == 2) h = T(1.0 / 3.0) * h + T(2.0 / 3.0) * n_h;
        } else {  // B5: the soil rhs's T of the top cell
          const T temp = rhs_temperature<T, M>(c, coef, top, vl, ti, re);
          turbulent_fluxes(c, a, load_atmos<T>(a, row, frow, col), vl, ti, temp,
                           &bc_val[BC_TOP_ENERGY], &bc_val[BC_TOP_HYDROLOGY]);
        }
        const Profiles<T, M> prof = load_profiles<T, M>(a, row, col);
        stage<T, M>(c, a, col, u, Y, out, s, bc_val, prof, g, dt, coef);
      }
    }
  }
  if (land) h_s[col] = h;
}

// kTable: the stage table's instance of mode M (land_rk_kernel.cu, land_policy_rk_kernel.cu), else SSPRK33's
// fixed stages (land_kernel.cu, land_policy_kernel.cu).
template <typename T, int M, bool kTable>
int launch(const KernelArgs* args, int block, void* stream) {
  const int64_t grid = (args->ncol + block - 1) / block;
  land_column_kernel<T, M, kTable><<<static_cast<unsigned>(grid), block, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

// The surface modes each source instantiates with stepping K (the fixed SSPRK33 stages or the stage table) and
// the extra mode bit C (0, or MODE_COLUMNS: per-column BC kinds and geometry): B5 and B2+B5 on a soil column; B6
// (with MOST) and B6-pond (a plain top BC), each with or without the frozen exchange and lagged coefficients;
// B6-pond on a water-only soil (MODE_WATER) likewise.
#define LAND_SURFACE_CASES(K, C)                                                                              \
  case MODE_MOST | C: return launch<T, MODE_MOST | C, K>(args, block, stream);                                \
  case MODE_MOST | MODE_LAGGED | C: return launch<T, MODE_MOST | MODE_LAGGED | C, K>(args, block, stream);    \
  LAND_TOP_CASES(MODE_LAND | MODE_MOST | C, K)                                                                \
  LAND_TOP_CASES(MODE_LAND | C, K)                                                                            \
  LAND_TOP_CASES(MODE_LAND | MODE_WATER | C, K)
#define LAND_TOP_CASES(S, K)                                                                                  \
  case S: return launch<T, S, K>(args, block, stream);                                                        \
  case S | MODE_SURFACE_STEP: return launch<T, S | MODE_SURFACE_STEP, K>(args, block, stream);                \
  case S | MODE_LAGGED: return launch<T, S | MODE_LAGGED, K>(args, block, stream);                            \
  case S | MODE_LAGGED | MODE_SURFACE_STEP: return launch<T, S | MODE_LAGGED | MODE_SURFACE_STEP, K>(args, block, stream);
// The step policies on top S (rate and equilibrium freeze-thaw, assume_no_ice, each alone and lagged): the
// five tops of B5 and B6, and assume_no_ice on the water-only LandModel (freeze-thaw needs dynamic energy).
// Every no-ice instance carries MODE_RHS_CAP: its stage rhs caps theta_l at nu - theta_i, as rhs.py does.
#define LAND_POLICY_CASES(S, K)                                                                               \
  case S | MODE_FREEZE_RATE: return launch<T, S | MODE_FREEZE_RATE, K>(args, block, stream);                  \
  case S | MODE_FREEZE_EQ: return launch<T, S | MODE_FREEZE_EQ, K>(args, block, stream);                      \
  case S | MODE_NO_ICE: return launch<T, S | MODE_NO_ICE | MODE_RHS_CAP, K>(args, block, stream);             \
  case S | MODE_LAGGED | MODE_FREEZE_RATE:                                                                    \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_RATE, K>(args, block, stream);                             \
  case S | MODE_LAGGED | MODE_FREEZE_EQ:                                                                      \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_EQ, K>(args, block, stream);                               \
  case S | MODE_LAGGED | MODE_NO_ICE:                                                                         \
    return launch<T, S | MODE_LAGGED | MODE_NO_ICE | MODE_RHS_CAP, K>(args, block, stream);
#define LAND_WATER_POLICY_CASES(S, K)                                                                         \
  case S | MODE_WATER | MODE_NO_ICE:                                                                          \
    return launch<T, S | MODE_WATER | MODE_NO_ICE | MODE_RHS_CAP, K>(args, block, stream);                    \
  case S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE:                                                            \
    return launch<T, S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE | MODE_RHS_CAP, K>(args, block, stream);
// The 34 policy modes with stepping K and the extra mode bit C, as LAND_SURFACE_CASES.
#define LAND_ALL_POLICY_CASES(K, C)                                                                           \
  LAND_POLICY_CASES(MODE_MOST | C, K)                                                                         \
  LAND_POLICY_CASES(MODE_LAND | MODE_MOST | C, K)                                                             \
  LAND_POLICY_CASES(MODE_LAND | MODE_MOST | MODE_SURFACE_STEP | C, K)                                         \
  LAND_POLICY_CASES(MODE_LAND | C, K)                                                                         \
  LAND_POLICY_CASES(MODE_LAND | MODE_SURFACE_STEP | C, K)                                                     \
  LAND_WATER_POLICY_CASES(MODE_LAND | C, K)                                                                   \
  LAND_WATER_POLICY_CASES(MODE_LAND | MODE_SURFACE_STEP | C, K)

}  // namespace
