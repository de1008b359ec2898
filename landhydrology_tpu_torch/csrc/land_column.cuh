// The fused multi-step column kernel with a surface exchange at the top
// face: SSPRK33 steps, one thread per column (kernel modes B5 and B6, and B7,
// their streamed forcing rows), and its launch.  Two sources instantiate it:
// land_kernel.cu the surface modes alone and with lagged coefficients,
// land_policy_kernel.cu the surface modes with freeze-thaw or assume_no_ice
// (each alone or with lagged coefficients); each also the LandModel on a
// water-only soil under its plain top (MODE_WATER, land_policy_kernel.cu
// with assume_no_ice).
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// where its body traces a MOST top face (B5: PrescribedAtmosForcing, the
// rhs through boundary.py::boundary_fluxes) or the LandModel (B6:
// models/land.py, the pond height h_s one more per-column in/out value,
// column_kernel.py:111-137, :385-411, :613-621).  The mode word selects:
//   MODE_MOST          the top fluxes from a MOST solve (surface_fluxes.cuh);
//   MODE_LAND          the pond store: the soil's top water flux is
//                      -infiltration + evap_soil, its top energy flux the
//                      MOST heat flux (with MODE_MOST) or its own top energy
//                      BC, and dh_s/dt = P - infiltration - evap_pond is
//                      stepped with the soil's stage coefficients;
//   MODE_SURFACE_STEP  LandModel(surface_update="step"): the exchange is
//                      evaluated once per step from the step's start state
//                      and held across the stages (FrozenExchangeStepper);
//   MODE_LAGGED        coefficient_update="step" (kernel B2);
//   MODE_FREEZE_RATE   FreezeThaw: the rate sources in every stage's soil rhs
//                      (with MODE_LAGGED through the lagged rho_c_s);
//   MODE_FREEZE_EQ     EquilibriumFreezeThaw: the projection of the soil
//                      fields after the last stage (ssprk33.cuh), so a frozen
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
//                      carries no T.
// B7 (column_kernel.py:413-475, :512-575, forcing_fields and
// forcing_time_grid) is a row source, not a mode: the forced atmosphere
// fields and the rain rate are read at the step's forcing row (the step, or
// the time-indexed row of the step's start time) for all three stages and
// for a frozen exchange; the others keep their stage rows.  The rows stay in
// global memory (no copy per launch: the pointers carry the launch's chunk
// offset), read once per column and exchange.
// B5 reads T of the top cell as the soil rhs has it (rhs_temperature:
// through the lagged heat capacity in B2+B5; under assume_no_ice without the
// ice terms, as rhs.py's no-ice closures diagnose it); B6's exchange
// diagnoses T of the top slab in full, as land.py does, assume_no_ice or
// not.  The exchange reads only the top cell, and its
// rates replace the top face's BC values of the stage's rhs sweep.
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

template <typename T, int M>
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
  if (land) h_s[col] = h;
}

template <typename T, int M>
int launch(const KernelArgs* args, int block, void* stream) {
  const int64_t grid = (args->ncol + block - 1) / block;
  land_column_kernel<T, M><<<static_cast<unsigned>(grid), block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
