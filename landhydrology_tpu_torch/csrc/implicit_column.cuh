// The fused multi-step soil-column kernel of the implicit steppers (kernel mode
// B4): TR-BDF2, backward Euler for Richards, and backward Euler for the
// coupled soil, one thread per column, `n_steps` steps per launch, in place,
// and its launch.  Six sources instantiate it: implicit_kernel.cu the plain
// soil and the MOST top without the step policies, implicit_policy_kernel.cu
// the plain soil with them, implicit_most_kernel.cu the MOST top with them,
// implicit_branch_kernel.cu the step policies on the water-only branch,
// implicit_columns_kernel.cu the plain soil's policy instances and
// BackwardEulerSoil with per-column BC kinds and geometry (MODE_COLUMNS), and
// implicit_most_columns_kernel.cu the three steppers under the MOST top, with
// the policies or without, with MODE_COLUMNS.
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// in its implicit modes, whose body traces landhydrology_tpu/imex.py
// (TRBDF2Soil.step/_solve_stage, BackwardEulerRichards, BackwardEulerSoil,
// _water_newton_sweep, _heat_newton_sweep, _backward_euler_delta) and
// ops/tridiag.py (thomas_solve, pcr_solve).  The template parameter M is the
// mode word (column_common.cuh): one stepper bit and the branch (coupled,
// MODE_WATER, MODE_HEAT).  MODE_PCR selects the tridiagonal solver at run
// time.  MODE_MOST (a PrescribedAtmosForcing top, kernel mode B5, coupled
// branch only) takes the top face's heat and water fluxes of every rhs
// evaluation from a MOST solve at that evaluation's own top cell
// (surface_fluxes.cuh), at the stage row's atmosphere or, with streamed
// forcing rows (B7), at the step's forcing row for all stages and sweeps; it
// adds no Jacobian term (imex.py boosts a Dirichlet slot alone).
//
// The step policies on the coupled branch (kernel B4 with B2, B3 and no ice,
// on the plain soil and under MOST), as the eager stepper's wrappers order
// them (LaggedCoefficientStepper(PhaseEquilibriumStepper(stepper))):
//   MODE_LAGGED       the coefficients of lagged.py at the step's start
//                     state (column_common.cuh::coefficients) in every rhs
//                     evaluation of the step; the Newton sweeps' Jacobian
//                     stays live at the iterate (imex.py computes it there);
//   MODE_FREEZE_RATE  the rate sources in every rhs; TR-BDF2's stages end
//                     with theta_i = c + w f_i(u), BackwardEulerSoil's step
//                     with theta_i += dt f_i at its new state, and
//                     BackwardEulerRichards updates theta_i explicitly;
//   MODE_FREEZE_EQ    the equilibrium projection of every cell after each
//                     step (column_common.cuh::phase_projection);
//   MODE_NO_ICE       the no-ice closures in the rhs; the sweeps' Jacobian
//                     keeps the state's ice, as imex.py's sweeps do.
// On the water-only branch (implicit_branch_kernel.cu) the policies are
// lagged coefficients, assume_no_ice and both: MODE_LAGGED lags K alone, at
// the step's start state (column_common.cuh's branch_coefficients,
// lagged.py:50-92; it reads no T: TemperatureDependentViscosity is refused
// on this branch's sweep, so the profile row it is given does not matter);
// the water sweep's K stays live at the iterate with the state's ice.  The
// heat-only branch takes no policy: the reference's implicit heat sweep
// reads theta_i from a state that holds none (imex.py:231).
// Under MODE_MOST each MOST solve reads T of the top cell as that rhs
// evaluation's rhs diagnoses it (surface_fluxes.cuh::rhs_temperature): through
// the step's lagged heat capacity, or the no-ice closures, as the land kernel
// reads it for SSPRK33.
// Per step, as imex.py orders it:
//   TR-BDF2   f(u^n) at t -> c1 = u^n + w1 f(u^n); the TR stage at t + g dt
//             from u^n; c2 = a1 u* + a2 u^n; the BDF2 stage at t + dt from
//             u*.  Each stage is `iters` Gauss-Seidel sweeps: water, heat,
//             then theta_i = c (or its rate fixed point);
//   BE        `iters` water sweeps at t + dt; then BackwardEulerSoil's
//             `iters` heat sweeps, or BackwardEulerRichards' explicit update
//             of theta_i and rho_e_int at the new water state (coupled; in
//             the water-only branch that update adds dt * 0 to theta_i and
//             is left out).
// Each Newton sweep is three passes over the column:
//   1. the rhs at the iterate (rhs_sweep, the explicit kernel's code), which
//      stores the swept component's tendency F, its diffusion coefficient K
//      (hydraulic K or kappa) and C (d psi/d vartheta_l in closed form, or
//      1/rho_c_s) in scratch;
//   2. the tridiagonal rows of (I - w A) delta = c - u + w F with the
//      Dirichlet boosts, eliminated on the fly (Thomas: forward sweep storing
//      cp and dp) or stored for PCR's ceil(log2 nz) passes over two buffers;
//   3. back substitution (or x = b/d after PCR) with the trust clamp to half
//      the column's porosity on water, updating the iterate in place.
//
// Bound: like the explicit kernel, the closures' exp/log in every rhs
// evaluation (1 + 2 iters x components per TR-BDF2 step), less kappa in a
// coupled water sweep, which reads only the water tendency.  The sweep
// computes kappa and the energy flux all the same: compiling them out left
// the kernel's time unchanged.  The design keeps every intermediate of the
// column in global memory (coalesced at k*ncol + col): a sweep moves about
// 17 values per cell (pass 1 reads the state and writes F, K, C; pass 2
// reads them, c and u, and writes cp, dp; pass 3 reads cp, dp, u and writes
// u), which at 65,536 columns x 64 levels (33.5 MB per f64 field) does not
// stay in the 50 MB L2.  Keeping a column block's F, K, C and cp, dp in
// shared memory or registers is the obvious next step.

#pragma once

#include "surface_fluxes.cuh"

namespace {

// The scratch fields of one Newton sweep, (nz, ncol) each.
template <typename T>
struct Work {
  T* F;       // tendency of the swept component at the iterate
  T* K;       // its diffusion coefficient at the centers
  T* C;       // d psi / d vartheta_l, or 1 / rho_c_s
  T* sol[8];  // Thomas: cp, dp; PCR: (a, c, d, b) twice
};

// imex.py k_at_value: K at a Dirichlet water value, with unit viscosity and
// impedance factors.
template <typename T>
__device__ T k_at_value(const Column<T>& c, T v_dir) {
  T S_f = effective_saturation(c, c.p[P_NU], v_dir);
  return hydraulic_conductivity(c, S_f, T(1), T(1));
}

// The water sweep's K at the iterate (_water_newton_sweep): the stage
// closures with the state's ice, whatever the rhs lags or assumes.
template <typename T>
__device__ T sweep_conductivity(const Column<T>& c, T vl, T ti, T re) {
  T theta_l = d_min(vl, c.p[P_NU] - ti);
  T rcs = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l + ti * c.rho_cp_i;
  T temp = c.T_0 + (re + ti * c.rho_ice * c.LH_f0) / rcs;
  return conductivity(c, vl, ti, temp);
}

// The heat sweep's kappa and rho_c_s at the iterate (_heat_newton_sweep):
// energy_center_fields of theta_l = min(vartheta_l, nu - theta_i), without
// the frozen branches under MODE_NO_ICE.
template <typename T, int M>
__device__ void sweep_thermal(const Column<T>& c, T vl, T ti, T* kappa, T* rcs) {
  T theta_l = d_min(vl, c.p[P_NU] - ti);
  if (Modes<M>::no_ice) {
    *rcs = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l;
    *kappa = thermal_conductivity_no_ice(c, theta_l);
  } else {
    *rcs = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l + ti * c.rho_cp_i;
    *kappa = thermal_conductivity(c, vl, ti);
  }
}

// _water_newton_sweep (kWater) or _heat_newton_sweep: one frozen-coefficient
// Newton update of the stage equation u = c_const + w f(u) for the iterate
// `st` of one column, at the BC values and profiles of table row `row` (and
// under a MOST top the forcing row `frow`), with the step's lagged
// coefficients `coef` under MODE_LAGGED; updates st.vl (water) or st.re
// (heat) in place.
template <typename T, int M, bool kWater>
__device__ void newton_sweep(const Column<T>& c, const KernelArgs& a, int64_t col,
                             Fields<T> st, const T* c_const, T w, int64_t row, int64_t frow,
                             const Grid<T, M>& g, const Work<T>& wk, const Coefs<T>& coef) {
  const int64_t nz = a.nz, ncol = a.ncol;
  const T dz = g.dz;
  T bc_val[kNumBC];
  load_bc(a, row, col, bc_val);
  if constexpr (Modes<M>::most) {  // the MOST fluxes at the iterate's top cell
    const int64_t i = (nz - 1) * ncol + col;
    most_top_bc<T, M>(c, a, coef, row, frow, col, i, st.vl[i], st.ti[i], st.re[i], bc_val);
  }
  // the center's K, kappa and rho_c_s are the rhs's: lagged or without ice
  // they are not the sweep's
  constexpr bool live = Modes<M>::lagged || Modes<M>::no_ice;

  // 1. the rhs at the iterate, and the frozen coefficients
  rhs_sweep<T, M>(c, a, col, st, bc_val, load_profiles<T, M>(a, row, col), g, coef,
                  [&](int64_t k, const Center<T>& x, T d_vl, T d_ti, T d_re) {
                    const int64_t i = k * ncol + col;
                    if (kWater) {
                      wk.F[i] = d_vl;
                      wk.K[i] = live ? sweep_conductivity(c, x.vl, x.ti, x.re) : x.K;
                      wk.C[i] = dpsi_dtheta(c, x.vl, c.p[P_NU] - x.ti);
                    } else {
                      T kappa = x.kappa, rcs = x.rcs;
                      if constexpr (live) sweep_thermal<T, M>(c, x.vl, x.ti, &kappa, &rcs);
                      wk.F[i] = d_re;
                      wk.K[i] = kappa;
                      wk.C[i] = T(1) / rcs;
                    }
                  });

  // Dirichlet faces: -K_face C_i / (dz_half dz) on the diagonal, with
  // K_face at the Dirichlet value for water and the center kappa for heat;
  // keyed on the slot's kind, so a BatchedBC column of kind Dirichlet gets
  // none (imex.py boosts a plain Dirichlet alone)
  const T dzb = dz / T(2);
  const int64_t bot = col, top = (nz - 1) * ncol + col;
  const int slot_bot = kWater ? BC_BOTTOM_HYDROLOGY : BC_BOTTOM_ENERGY;
  const int slot_top = kWater ? BC_TOP_HYDROLOGY : BC_TOP_ENERGY;
  T boost_bot = T(0), boost_top = T(0);
  if (a.bc_kind[slot_bot] == BC_DIRICHLET) {
    T K_f = kWater ? k_at_value(c, bc_val[slot_bot]) : wk.K[bot];
    boost_bot = (-K_f) * wk.C[bot] / (dzb * dz);
  }
  if (a.bc_kind[slot_top] == BC_DIRICHLET) {
    T K_f = kWater ? k_at_value(c, bc_val[slot_top]) : wk.K[top];
    boost_top = (-K_f) * wk.C[top] / (dzb * dz);
  }

  T* u = kWater ? st.vl : st.re;
  const T lim = T(0.5) * c.p[P_NU];
  auto rhs_b = [&](int64_t i) { return c_const[i] - u[i] + w * wk.F[i]; };
  // 3. the update; the trust region clamps water to half the porosity
  auto update = [&](int64_t i, T delta) {
    if (kWater) delta = d_min(d_max(delta, -lim), lim);
    u[i] = u[i] + delta;
  };

  if (nz == 1) {  // a single cell: the system is diagonal
    T d = T(1) - w * (boost_bot + boost_top);
    update(bot, rhs_b(bot) / d);
    return;
  }

  // 2. row r of I - w A: dl multiplies delta[r-1], du delta[r+1]
  const T inv_dz2 = T(1) / (dz * dz);
  auto row_coefs = [&](int64_t r, T* dl, T* d, T* du) {
    const int64_t i = r * ncol + col;
    const T Kr = wk.K[i], Cr = wk.C[i];
    const T Km = r > 0 ? T(0.5) * (wk.K[i - ncol] + Kr) : T(0);       // face below
    const T Kp = r < nz - 1 ? T(0.5) * (Kr + wk.K[i + ncol]) : T(0);  // face above
    const T Cd = r > 0 ? wk.C[i - ncol] : Cr;
    const T Cu = r < nz - 1 ? wk.C[i + ncol] : Cr;
    T diag = (-(Km + Kp)) * Cr * inv_dz2;
    if (r == 0) diag = diag + boost_bot;
    if (r == nz - 1) diag = diag + boost_top;
    *dl = (-w) * (Km * Cd * inv_dz2);
    *d = T(1) - w * diag;
    *du = (-w) * (Kp * Cu * inv_dz2);
  };

  if (!(a.mode & MODE_PCR)) {
    // Thomas, reciprocal-multiply form (tridiag.py::thomas_solve)
    T* cp = wk.sol[0];
    T* dp = wk.sol[1];
    T cp_prev = T(0), dp_prev = T(0);
    for (int64_t r = 0; r < nz; ++r) {
      const int64_t i = r * ncol + col;
      T dl, d, du;
      row_coefs(r, &dl, &d, &du);
      const T b = rhs_b(i);
      const T inv = r == 0 ? T(1) / d : T(1) / (d - dl * cp_prev);
      cp_prev = du * inv;
      dp_prev = (r == 0 ? b : b - dl * dp_prev) * inv;
      cp[i] = cp_prev;
      dp[i] = dp_prev;
    }
    T x = dp_prev;
    update(top, x);
    for (int64_t r = nz - 2; r >= 0; --r) {
      const int64_t i = r * ncol + col;
      x = dp[i] - cp[i] * x;
      update(i, x);
    }
    return;
  }

  // parallel cyclic reduction (tridiag.py::pcr_solve): at stride s every row
  // eliminates its +-s neighbours; out-of-range neighbours are the identity
  // row (d = 1, a = c = b = 0)
  T* A[4] = {wk.sol[0], wk.sol[1], wk.sol[2], wk.sol[3]};  // a, c, d, b
  T* B[4] = {wk.sol[4], wk.sol[5], wk.sol[6], wk.sol[7]};
  for (int64_t r = 0; r < nz; ++r) {
    const int64_t i = r * ncol + col;
    T dl, d, du;
    row_coefs(r, &dl, &d, &du);
    A[0][i] = r == 0 ? T(0) : dl;
    A[1][i] = r == nz - 1 ? T(0) : du;
    A[2][i] = d;
    A[3][i] = rhs_b(i);
  }
  for (int64_t s = 1; s < nz; s *= 2) {
    for (int64_t r = 0; r < nz; ++r) {
      const int64_t i = r * ncol + col, i_dn = i - s * ncol, i_up = i + s * ncol;
      const bool dn = r >= s, up = r + s < nz;
      const T alpha = (-A[0][i]) * (dn ? T(1) / A[2][i_dn] : T(1));
      const T gamma = (-A[1][i]) * (up ? T(1) / A[2][i_up] : T(1));
      const T a_dn = dn ? A[0][i_dn] : T(0), c_dn = dn ? A[1][i_dn] : T(0);
      const T b_dn = dn ? A[3][i_dn] : T(0);
      const T a_up = up ? A[0][i_up] : T(0), c_up = up ? A[1][i_up] : T(0);
      const T b_up = up ? A[3][i_up] : T(0);
      B[2][i] = A[2][i] + alpha * c_dn + gamma * a_up;
      B[3][i] = A[3][i] + alpha * b_dn + gamma * b_up;
      B[0][i] = alpha * a_dn;
      B[1][i] = gamma * c_up;
    }
    for (int j = 0; j < 4; ++j) {
      T* swap = A[j];
      A[j] = B[j];
      B[j] = swap;
    }
  }
  for (int64_t r = 0; r < nz; ++r) {
    const int64_t i = r * ncol + col;
    update(i, A[3][i] / A[2][i]);
  }
}

template <typename T, int M>
__global__ void implicit_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  constexpr bool has_water = !Modes<M>::heat, has_heat = !Modes<M>::water;
  const Column<T> c = load_column<T>(a, col, eps, tiny);
  const T dt = T(a.dt);
  const Grid<T, M> g = load_grid<T, M>(a, col);
  const int64_t nz = a.nz, ncol = a.ncol, n = nz * ncol;
  T* scratch = static_cast<T*>(a.scratch);
  Fields<T> Y{static_cast<T*>(a.vartheta_l), static_cast<T*>(a.theta_i),
              static_cast<T*>(a.rho_e_int)};
  Fields<T> S{scratch, scratch + n, scratch + 2 * n};           // the iterate
  Fields<T> Cs{scratch + 3 * n, scratch + 4 * n, scratch + 5 * n};  // stage constants
  Work<T> wk{scratch + 6 * n, scratch + 7 * n, scratch + 8 * n, {}};
  for (int j = 0; j < 8; ++j) wk.sol[j] = scratch + (9 + j) * n;
  // the lagged coefficients, after the solver's fields
  Coefs<T> coef{};
  if constexpr (Modes<M>::lagged) {
    T* base = scratch + (9 + ((a.mode & MODE_PCR) ? 8 : 2)) * n;
    coef = Coefs<T>{base, base + n, base + 2 * n, base + 3 * n, base + 4 * n};
  }

  auto copy = [&](const T* from, T* to) {
    for (int64_t k = 0; k < nz; ++k) to[k * ncol + col] = from[k * ncol + col];
  };
  // theta_i's rate source at each cell of u: the rhs's tendency of theta_i
  auto ice_source = [&](Fields<T> u, auto update) {
    for (int64_t k = 0; k < nz; ++k) {
      const int64_t i = k * ncol + col;
      update(i, center_fields<T, M>(c, coef, i, u.vl[i], u.ti[i], u.re[i], T(0), g.z(k)).src_i);
    }
  };
  // TRBDF2Soil._solve_stage: u = Cs + w f(u) by Gauss-Seidel sweeps of S
  auto solve_stage = [&](T w, int64_t row, int64_t frow) {
    for (int64_t it = 0; it < a.iters; ++it) {
      if constexpr (has_water) newton_sweep<T, M, true>(c, a, col, S, Cs.vl, w, row, frow, g, wk, coef);
      if constexpr (has_heat) newton_sweep<T, M, false>(c, a, col, S, Cs.re, w, row, frow, g, wk, coef);
      if constexpr (Modes<M>::rate) {  // the phase change's fixed point
        ice_source(S, [&](int64_t i, T src) { S.ti[i] = Cs.ti[i] + w * (T(0) + src); });
      } else if constexpr (has_water) {
        copy(Cs.ti, S.ti);  // zero tendency: theta_i = c
      }
    }
  };

  [[maybe_unused]] const int64_t top = (nz - 1) * ncol + col;  // read under MODE_MOST
  for (int64_t step = 0; step < a.n_steps; ++step) {
    const int64_t row0 = a.rows_per_step * step;
    if constexpr (Modes<M>::lagged && Modes<M>::water) {  // K at the step's start state
      branch_coefficients<T, M>(c, a, col, Y, load_profiles<T, M>(a, row0, col), coef);
    } else if constexpr (Modes<M>::lagged) {
      coefficients<T, M>(c, a, col, Y.vl, Y.ti, Y.re, coef);
    }
    // the step's forcing row (B7), one for all stages and sweeps
    int64_t frow = 0;
    if constexpr (Modes<M>::most) {
      frow = forcing_row<T>(a.frow_mode, step, T(a.t0), dt, T(a.t_forcing0), T(a.inv_dt_forcing), a.n_frows);
    }
    if constexpr (Modes<M>::trbdf2) {
      const T w1 = T(a.half_g) * dt, w2 = T(a.b_bdf2) * dt;
      const T a1 = T(a.a1), a2 = T(a.a2);
      // f(u^n) at t: c1 = u^n + w1 f(u^n), and the TR stage starts at u^n
      T bc_val[kNumBC];
      load_bc(a, row0, col, bc_val);
      if constexpr (Modes<M>::most) {
        most_top_bc<T, M>(c, a, coef, row0, frow, col, top, Y.vl[top], Y.ti[top], Y.re[top], bc_val);
      }
      rhs_sweep<T, M>(c, a, col, Y, bc_val, load_profiles<T, M>(a, row0, col), g, coef,
                      [&](int64_t k, const Center<T>& x, T d_vl, T d_ti, T d_re) {
                        const int64_t i = k * ncol + col;
                        if (has_water) {
                          Cs.vl[i] = x.vl + w1 * d_vl;
                          Cs.ti[i] = x.ti + w1 * d_ti;
                          S.vl[i] = x.vl;
                          S.ti[i] = x.ti;
                        }
                        if (has_heat) {
                          Cs.re[i] = x.re + w1 * d_re;
                          S.re[i] = x.re;
                        }
                      });
      solve_stage(w1, row0 + 1, frow);  // at t + g dt
      // c2 = a1 u* + a2 u^n; the BDF2 stage starts at u*
      for (int64_t k = 0; k < nz; ++k) {
        const int64_t i = k * ncol + col;
        if (has_water) {
          Cs.vl[i] = a1 * S.vl[i] + a2 * Y.vl[i];
          Cs.ti[i] = a1 * S.ti[i] + a2 * Y.ti[i];
        }
        if (has_heat) Cs.re[i] = a1 * S.re[i] + a2 * Y.re[i];
      }
      solve_stage(w2, row0 + 2, frow);  // at t + dt
      if (has_water) {
        copy(S.vl, Y.vl);
        copy(S.ti, Y.ti);
      }
      if (has_heat) copy(S.re, Y.re);
    } else {
      // backward Euler: every evaluation at t + dt (row0)
      copy(Y.vl, S.vl);
      const Fields<T> st{S.vl, Y.ti, Y.re};
      for (int64_t it = 0; it < a.iters; ++it) {
        newton_sweep<T, M, true>(c, a, col, st, Y.vl, dt, row0, frow, g, wk, coef);
      }
      if constexpr (Modes<M>::be_soil) {
        copy(Y.re, S.re);
        const Fields<T> sh{S.vl, Y.ti, S.re};
        for (int64_t it = 0; it < a.iters; ++it) {
          newton_sweep<T, M, false>(c, a, col, sh, Y.re, dt, row0, frow, g, wk, coef);
        }
        if constexpr (Modes<M>::rate) {  // the phase change, explicit at the new state
          ice_source(sh, [&](int64_t i, T src) { Y.ti[i] = Y.ti[i] + dt * (T(0) + src); });
        }
        copy(S.re, Y.re);
      } else if constexpr (Modes<M>::coupled) {
        // theta_i and rho_e_int explicit at the new water state, in place
        T bc_val[kNumBC];
        load_bc(a, row0, col, bc_val);
        if constexpr (Modes<M>::most) {
          most_top_bc<T, M>(c, a, coef, row0, frow, col, top, S.vl[top], Y.ti[top], Y.re[top], bc_val);
        }
        rhs_sweep<T, M>(c, a, col, st, bc_val, load_profiles<T, M>(a, row0, col), g, coef,
                        [&](int64_t k, const Center<T>& x, T d_vl, T d_ti, T d_re) {
                          const int64_t i = k * ncol + col;
                          Y.ti[i] = x.ti + dt * d_ti;
                          Y.re[i] = x.re + dt * d_re;
                        });
      }
      copy(S.vl, Y.vl);
    }
    if constexpr (Modes<M>::eq) {
      for (int64_t k = 0; k < nz; ++k) {
        const int64_t i = k * ncol + col;
        phase_projection(c, &Y.vl[i], &Y.ti[i], Y.re[i]);
      }
    }
  }
}

template <typename T, int M>
int launch(const KernelArgs* args, int block, void* stream) {
  const int64_t grid = (args->ncol + block - 1) / block;
  implicit_column_kernel<T, M><<<static_cast<unsigned>(grid), block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min());
  return static_cast<int>(cudaGetLastError());
}

// The step policies of the coupled branch on stepper (and top) bits S, one
// instance each: lagged coefficients alone or with either freeze-thaw
// scheme or assume_no_ice, and either scheme or no ice alone.  The no-ice
// instance carries MODE_RHS_CAP (the rhs caps theta_l at nu - theta_i, as
// rhs.py and imex.py's sweeps do); the lagged one caps at nu in its
// coefficients, as lagged.py does, and reads no other theta_l.
#define POLICY_CASES(S)                                                                              \
  case S | MODE_LAGGED: return launch<T, S | MODE_LAGGED>(args, block, stream);                     \
  case S | MODE_FREEZE_RATE: return launch<T, S | MODE_FREEZE_RATE>(args, block, stream);           \
  case S | MODE_FREEZE_EQ: return launch<T, S | MODE_FREEZE_EQ>(args, block, stream);               \
  case S | MODE_NO_ICE: return launch<T, S | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);      \
  case S | MODE_LAGGED | MODE_FREEZE_RATE:                                                          \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_RATE>(args, block, stream);                      \
  case S | MODE_LAGGED | MODE_FREEZE_EQ:                                                            \
    return launch<T, S | MODE_LAGGED | MODE_FREEZE_EQ>(args, block, stream);                        \
  case S | MODE_LAGGED | MODE_NO_ICE: return launch<T, S | MODE_LAGGED | MODE_NO_ICE>(args, block, stream);

// The step policies of the water-only branch on stepper bits S (TR-BDF2 or
// backward Euler for Richards): lagged K, no ice, or both.  The no-ice
// instances carry MODE_RHS_CAP, as every no-ice instance of the explicit
// kernels does (on this branch the rhs reads theta_l for no closure, so the
// cap changes nothing).
#define WATER_POLICY_CASES(S)                                                                           \
  case S | MODE_WATER | MODE_LAGGED: return launch<T, S | MODE_WATER | MODE_LAGGED>(args, block, stream); \
  case S | MODE_WATER | MODE_NO_ICE:                                                                     \
    return launch<T, S | MODE_WATER | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);                  \
  case S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE:                                                       \
    return launch<T, S | MODE_WATER | MODE_LAGGED | MODE_NO_ICE | MODE_RHS_CAP>(args, block, stream);

}  // namespace
