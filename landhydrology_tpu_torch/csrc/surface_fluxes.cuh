// Monin-Obukhov surface fluxes and the land surface exchange for one column
// (one thread), in the working type T.
//
// Replaces the jnp code that landhydrology_tpu/ops/pallas/column_kernel.py
// traces into its kernel body for kernel modes B5 and B6:
// models/soil/surface_fluxes.py (the humidity helpers, the Businger psi
// differences with their polynomial arctan, the multisection solve of the
// Obukhov length, _assemble_fluxes, the blended pond/bare-soil split) and
// models/land.py::surface_exchange (potential infiltration, the pond supply),
// and, for kernel mode B7, the lookup of a step's streamed forcing row
// (column_kernel.py:426-446).
//
// The eager port (landhydrology_tpu_torch/models/soil/surface_fluxes.py) is
// followed operation for operation; Python-level constants are folded in
// double, as the host folds them, and then rounded to T.  The JAX package
// stacks the 8 probes of a round because the TPU has 8 sublanes; here the
// thread evaluates them in order and stops at the first one whose sign
// flips, which gives the same count j of leading probes on lo's side, so
// the bracket is the same.  The bracket arithmetic uses the _rn intrinsics
// (never contracted into a fused multiply-add), as the eager version rounds
// it.

#pragma once

#include "column_common.cuh"

namespace {

constexpr double kBusingerA = 4.7;
constexpr double kPrandtl0 = 0.74;
constexpr double kZetaBracket = 50.0;
constexpr double kZetaMin = -100.0, kZetaMax = 100.0;

template <typename T> __device__ __forceinline__ T d_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

template <typename T> __device__ __forceinline__ T clip(T x, T lo, T hi) {
  return d_min(d_max(x, lo), hi);
}

// The atmosphere fields and roughness lengths at one table row and column.
template <typename T>
struct Atmos {
  T u_atm, theta_atm, z_atm, theta_scale, rho_a, q_atm, z_0m, z_0s;
};

template <typename T>
__device__ __forceinline__ T surface_value(const KernelArgs& a, int j, int64_t row, int64_t col) {
  return static_cast<const T*>(a.surface_ptr[j])[row * a.surface_row_stride[j] +
                                                 col * a.surface_col_stride[j]];
}

// ---- streamed forcing rows (kernel B7) ----

// The forcing row of step `step`: the step itself, or for a time-indexed
// table (FROW_TIME) clip(trunc((t - t_F0) inv_dt_F), 0, n - 1) at the step's
// start time t = t0 + step dt, each operation rounded in T as the host
// rounds it (no fused multiply-add: a step that lands on a row boundary
// must read the row the plain version reads).
template <typename T>
__device__ __forceinline__ int64_t forcing_row(int64_t mode, int64_t step, T t0, T dt, T t_f0, T inv_dt_f,
                                               int64_t n) {
  if (mode != FROW_TIME) return step;
  const T t = rn_add(t0, rn_mul(T(step), dt));
  const int64_t j = trunc_int(rn_mul(rn_sub(t, t_f0), inv_dt_f));
  return j < 0 ? 0 : (j > n - 1 ? n - 1 : j);
}

// Surface input j at the stage row, or at the forcing row where it is forced.
template <typename T>
__device__ __forceinline__ T surface_at(const KernelArgs& a, int j, int64_t row, int64_t frow, int64_t col) {
  return surface_value<T>(a, j, (a.forced >> j) & 1 ? frow : row, col);
}

// The rain rate at the stage row (a table) or at the forcing row (streamed
// per step, scalar or per column), floored at zero as land.py floors it.
template <typename T>
__device__ __forceinline__ T rain_rate(const KernelArgs& a, int64_t row, int64_t frow, int64_t col) {
  const int64_t r = (a.forced >> kNumSurface) & 1 ? frow : row;
  return d_max(static_cast<const T*>(a.precip)[r * a.precip_row_stride + col * a.precip_col_stride], T(0));
}

template <typename T>
__device__ Atmos<T> load_atmos(const KernelArgs& a, int64_t row, int64_t frow, int64_t col) {
  return Atmos<T>{surface_at<T>(a, S_U_ATM, row, frow, col), surface_at<T>(a, S_THETA_ATM, row, frow, col),
                  surface_at<T>(a, S_Z_ATM, row, frow, col), surface_at<T>(a, S_THETA_SCALE, row, frow, col),
                  surface_at<T>(a, S_RHO_A_SFC, row, frow, col), surface_at<T>(a, S_Q_ATM, row, frow, col),
                  surface_value<T>(a, S_Z_0M, row, col), surface_value<T>(a, S_Z_0S, row, col)};
}

// ---- surface_fluxes.py: the Businger psi differences ----

template <typename T> __device__ __forceinline__ T odd_poly(T r) {
  T r2 = r * r;
  return r * (T(1) + r2 * (T(-1.0 / 3.0) +
                           r2 * (T(1.0 / 5.0) +
                                 r2 * (T(-1.0 / 7.0) + r2 * (T(1.0 / 9.0) + r2 * T(-1.0 / 11.0))))));
}

// _arctan_reduced: two half-angle reductions and the polynomial.
template <typename T> __device__ T arctan_reduced(T x) {
  T s = d_sign(x);
  T r = d_abs(x);
  for (int i = 0; i < 2; ++i) r = r / (T(1) + d_sqrt(T(1) + r * r));
  return s * T(4) * odd_poly(r);
}

template <typename T> __device__ T psi_m_diff(T zeta, T zeta_0) {
  zeta = clip(zeta, T(kZetaMin), T(kZetaMax));
  zeta_0 = clip(zeta_0, T(kZetaMin), T(kZetaMax));
  T x = d_sqrt(d_sqrt(T(1) - T(15) * d_min(zeta, T(0))));
  T x0 = d_sqrt(d_sqrt(T(1) - T(15) * d_min(zeta_0, T(0))));
  T one_px = T(1) + x, one_px0 = T(1) + x0;
  T ratio = (one_px * one_px * (T(1) + x * x)) / (one_px0 * one_px0 * (T(1) + x0 * x0));
  T atan_arg = (x - x0) / (T(1) + x * x0);
  T unstable = d_log(ratio) - T(2) * arctan_reduced(atan_arg);
  T stable = T(-kBusingerA) * (d_max(zeta, T(0)) - d_max(zeta_0, T(0)));
  return zeta < T(0) ? unstable : stable;
}

template <typename T> __device__ T psi_h_diff(T zeta, T zeta_0) {
  zeta = clip(zeta, T(kZetaMin), T(kZetaMax));
  zeta_0 = clip(zeta_0, T(kZetaMin), T(kZetaMax));
  T y = d_sqrt(T(1) - T(9) * d_min(zeta, T(0)));
  T y0 = d_sqrt(T(1) - T(9) * d_min(zeta_0, T(0)));
  T unstable = T(2) * d_log((T(1) + y) / (T(1) + y0));
  T stable = T(-kBusingerA / kPrandtl0) * (d_max(zeta, T(0)) - d_max(zeta_0, T(0)));
  return zeta < T(0) ? unstable : stable;
}

// ---- surface_fluxes.py::surface_conditions ----

// The Earth constants of the solve, by value: a reference to KernelArgs
// would make the kernel copy the whole struct to its stack for the call.
struct MostConstants {
  double kappa, grav, molmass_ratio;
};

__device__ __forceinline__ MostConstants most_constants(const KernelArgs& a) {
  return MostConstants{a.von_karman_const, a.grav, a.molmass_ratio};
}

// The column's constants of the consistency equation.
template <typename T>
struct Most {
  T z_atm, z_0m, z_0s, log_m, log_s, kdu, c0;
};

template <typename T>
__device__ __forceinline__ void most_denoms(const Most<T>& m, T Linv, T* denom_m, T* denom_s) {
  T zeta = m.z_atm * Linv, zeta_0m = m.z_0m * Linv, zeta_0s = m.z_0s * Linv;
  *denom_m = d_max(m.log_m - psi_m_diff(zeta, zeta_0m), T(1e-3));
  *denom_s = d_max(T(kPrandtl0) * (m.log_s - psi_h_diff(zeta, zeta_0s)), T(1e-3));
}

// h(1/L): the consistency equation multiplied through by the positive
// denom_s u_star_safe^2 denom_m^2 (no division).
template <typename T>
__device__ __forceinline__ T most_h(const Most<T>& m, T Linv) {
  T dm, ds;
  most_denoms(m, Linv, &dm, &ds);
  T M = d_max(m.kdu, T(1e-6) * dm);
  return Linv * ds * (M * M) - m.c0 * (dm * dm);
}

// The MOST scales (u*, theta*, q*) and denom_s at the solved 1/L, for a
// surface at rest with temperature theta_sfc and humidity q_sfc.
template <typename T>
__device__ __noinline__ void surface_conditions(const MostConstants k, const Atmos<T> at, T theta_sfc,
                                                T q_sfc, T* u_star, T* t_star, T* q_star,
                                                T* denom_s_out) {
  const double kappa = k.kappa;
  const T du = at.u_atm - T(0);
  const T dtheta = at.theta_atm - theta_sfc;
  const T dq = at.q_atm - q_sfc;
  Most<T> m;
  m.z_atm = at.z_atm;
  m.z_0m = at.z_0m;
  m.z_0s = at.z_0s;
  m.log_m = d_log(at.z_atm / at.z_0m);
  m.log_s = d_log(at.z_atm / at.z_0s);
  const T eps_vi = T(k.molmass_ratio - 1.0);
  T b_const = (T(1) + eps_vi * at.q_atm) * dtheta + eps_vi * at.theta_scale * dq;
  m.c0 = T(kappa * kappa * k.grav) * b_const / at.theta_scale;
  m.kdu = T(kappa) * du;

  // the root's sign is sign(c0): bracket [0, sign(c0) * 50 / z_atm]
  const T B = T(kZetaBracket) / at.z_atm;
  const T sgn = d_sign(m.c0);
  T lo = d_min(sgn, T(0)) * B, hi = d_max(sgn, T(0)) * B;
  T s_lo = d_sign(most_h(m, lo));
  if (s_lo == T(0)) s_lo = T(1);
  constexpr bool f64 = sizeof(T) == 8;
  constexpr int kRounds = f64 ? 20 : 4;
  const T inv = T(1.0 / 9.0);
  for (int round = 0; round < kRounds; ++round) {
    const T w = rn_sub(hi, lo);
    int j = 0;
    for (int r = 0; r < 8; ++r) {  // the leading probes still on lo's side
      T probe = rn_add(lo, rn_mul(T((r + 1.0) * (1.0 / 9.0)), w));
      if (!(most_h(m, probe) * s_lo > T(0))) break;
      ++j;
    }
    const T jt = T(j);
    const T lo_n = rn_add(lo, rn_mul(rn_mul(jt, inv), w));
    hi = rn_add(lo, rn_mul(rn_mul(d_min(jt + T(1), T(9)), inv), w));
    lo = lo_n;
  }
  T h_lo = most_h(m, lo), h_hi = most_h(m, hi);
  if (!f64) {  // float32: a first false-position step on the final bracket
    const T den1 = h_hi - h_lo;
    const bool ok1 = (h_lo * h_hi <= T(0)) && (d_abs(den1) > T(0));
    T x1 = (lo * h_hi - hi * h_lo) / (ok1 ? den1 : T(1));
    x1 = clip(x1, lo, hi);
    const T h1 = most_h(m, x1);
    const bool left = h_lo * h1 <= T(0);
    if (ok1 && !left) {
      lo = x1;
      h_lo = h1;
    }
    if (ok1 && left) {
      hi = x1;
      h_hi = h1;
    }
  }
  const T den = h_hi - h_lo;
  const bool use_falsi = (h_lo * h_hi <= T(0)) && (d_abs(den) > T(0));
  T Linv = clip((lo * h_hi - hi * h_lo) / (use_falsi ? den : T(1)), lo, hi);
  if (!use_falsi) Linv = T(0.5) * (lo + hi);
  T dm, ds;
  most_denoms(m, Linv, &dm, &ds);
  *u_star = T(kappa) * du / dm;
  *t_star = T(kappa) * dtheta / ds;
  *q_star = T(kappa) * dq / ds;
  *denom_s_out = ds;
}

// ---- the humidity and the fluxes ----

// q_vap_saturation_liquid at temperature `temp` and air density rho.
template <typename T>
__device__ T q_saturation(const KernelArgs& a, T temp, T rho) {
  const double dcp = a.cp_v - a.cp_l;
  T svp = T(a.press_triple) * d_pow(temp / T(a.T_triple), T(dcp / a.R_v)) *
          d_exp(T((a.LH_v0 - dcp * a.T_0) / a.R_v) * (T(1.0 / a.T_triple) - T(1) / temp));
  return svp / (rho * T(a.R_v) * temp);
}

// _soil_surface_humidity: q_sat and q_sat exp(g psi / R_v T).
template <typename T>
__device__ void soil_surface_humidity(const Column<T>& c, const KernelArgs& a, T vl, T ti, T temp,
                                      T rho, T* q_sat, T* q_soil) {
  *q_sat = q_saturation(a, temp, rho);
  T nu_eff = c.p[P_NU] - ti;
  T theta_l = d_min(vl, nu_eff);
  T S_l_eff = d_min(effective_saturation(c, nu_eff, theta_l), T(1));
  T psi = matric_potential(c, S_l_eff);
  *q_soil = *q_sat * d_exp(T(a.grav) * psi / T(a.R_v) / temp);
}

// _assemble_fluxes: (heat flux, water volume flux), positive upward.
template <typename T>
__device__ void assemble_fluxes(const KernelArgs& a, T rho, T temp, T q_sfc, T u_star, T t_star,
                                T q_star, T* heat, T* E_vol) {
  T cpm = T(a.cp_d) + T(a.cp_v - a.cp_d) * q_sfc;
  T h_d = T(a.cp_d) * (temp - T(a.T_0)) + T(a.R_d * a.T_0);
  T E = (-rho) * u_star * q_star;
  T dry = (-cpm) * rho * u_star * t_star - h_d * E;
  T vapor = (T(a.cp_v) * (temp - T(a.T_0)) + T(a.LH_v0)) * E;
  *heat = dry + vapor;
  *E_vol = E / T(a.rho_cloud_liq);
}

// compute_turbulent_surface_fluxes of the top cell (kernel B5).
template <typename T>
__device__ void turbulent_fluxes(const Column<T>& c, const KernelArgs& a, const Atmos<T>& at, T vl,
                                 T ti, T temp, T* heat, T* E_vol) {
  T q_sat, q_soil, u_star, t_star, q_star, ds;
  soil_surface_humidity(c, a, vl, ti, temp, at.rho_a, &q_sat, &q_soil);
  surface_conditions(most_constants(a), at, temp, q_soil, &u_star, &t_star, &q_star, &ds);
  assemble_fluxes(a, at.rho_a, temp, q_soil, u_star, t_star, q_star, heat, E_vol);
}

// T of a cell (vl, ti, re) as the soil rhs diagnoses it with its stage
// coefficients (and land.py on the top slab).
template <typename T>
__device__ __forceinline__ T cell_temperature(const Column<T>& c, T vl, T ti, T re) {
  T theta_l = d_min(vl, c.p[P_NU] - ti);
  T rho_c_s = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l + ti * c.rho_cp_i;
  return c.T_0 + (re + ti * c.rho_ice * c.LH_f0) / rho_c_s;
}

// T of cell i (vl, ti, re) as the soil rhs of mode M diagnoses it for its
// MOST top face (kernel B5): through the step's lagged heat capacity with
// lagged coefficients; without the ice terms under assume_no_ice, as rhs.py's
// no-ice closures diagnose it (theta_l capped as the rhs caps it); else the
// stage closures.
template <typename T, int M>
__device__ __forceinline__ T rhs_temperature(const Column<T>& c, const Coefs<T>& coef, int64_t i, T vl, T ti,
                                             T re) {
  if (Modes<M>::lagged && Modes<M>::no_ice) return c.T_0 + re * coef.inv_rho_c_s[i];
  if (Modes<M>::lagged) return c.T_0 + (re + ti * c.rho_ice * c.LH_f0) * coef.inv_rho_c_s[i];
  if (Modes<M>::no_ice) {
    return c.T_0 + re / (c.p[P_RHO_C_DS] + d_min(vl, Modes<M>::rhs_cap ? c.p[P_NU] - ti : c.p[P_NU]) * c.rho_cp_l);
  }
  return cell_temperature(c, vl, ti, re);
}

// The MOST top face of one rhs evaluation (kernel mode B5 under the
// implicit steppers): the turbulent heat and water fluxes of the top cell i
// (vl, ti, re), at T as the rhs diagnoses it (rhs_temperature, with the
// step's lagged coefficients `coef`), at table row `row` and forcing row
// `frow` replace the top slots' BC values, which the host sets to BC_FLUX.
template <typename T, int M>
__device__ __forceinline__ void most_top_bc(const Column<T>& c, const KernelArgs& a, const Coefs<T>& coef,
                                            int64_t row, int64_t frow, int64_t col, int64_t i, T vl, T ti, T re,
                                            T* bc_val) {
  turbulent_fluxes(c, a, load_atmos<T>(a, row, frow, col), vl, ti, rhs_temperature<T, M>(c, coef, i, vl, ti, re),
                   &bc_val[BC_TOP_ENERGY], &bc_val[BC_TOP_HYDROLOGY]);
}

// ---- land.py::surface_exchange ----

template <typename T>
struct Exchange {
  T P, infiltration, evap_soil, evap_pond, heat_flux;
};

// The exchange rates for the top cell (vl, ti, re) and the pond height h_s
// at table row `row` and forcing row `frow`: T diagnosed on the top slab, or
// on a water-only soil (MODE_WATER, no rho_e_int; re is not read) 288 K, as
// land.py::_diagnose_state_T gives it where the auxiliary state carries no
// T, as a fused run's does not; the potential infiltration is the Dirichlet
// branch of face_fluxes with the face at nu; with MOST, one solve over the
// blended pond/bare-soil humidity.
template <typename T, int M>
__device__ Exchange<T> surface_exchange(const Column<T>& c, const KernelArgs& a, int64_t row,
                                        int64_t frow, int64_t col, T vl, T ti, T re, T h_s, T dzb,
                                        T tau_pond, T h_evap_smoothing) {
  Exchange<T> ex;
  T temp = Modes<M>::water ? T(288) : cell_temperature(c, vl, ti, re);

  Center<T> x{};
  x.vl = vl;
  x.ti = ti;
  x.temp = temp;
  x.psi = pressure_head(c, vl, c.p[P_NU] - ti);
  T f_e, f_w;
  face_fluxes<T, M>(c, x, BC_FLUX, BC_FLUX, T(0), BC_DIRICHLET, BC_DIRICHLET, c.p[P_NU], true, false, dzb,
                    &f_e, &f_w);
  T f_pot = d_max(-f_w, T(0));

  ex.P = rain_rate<T>(a, row, frow, col);
  T h_pos = d_max(h_s, T(0));
  ex.infiltration = d_min(ex.P + h_pos / tau_pond, f_pot);
  ex.evap_soil = ex.evap_pond = ex.heat_flux = T(0);
  if (Modes<M>::most) {
    const Atmos<T> at = load_atmos<T>(a, row, frow, col);
    T w = clip(h_pos / h_evap_smoothing, T(0), T(1));
    T q_sat, q_soil;
    soil_surface_humidity(c, a, vl, ti, temp, at.rho_a, &q_sat, &q_soil);
    T one_m_w = T(1) - w;
    T q_eff = one_m_w * q_soil + w * q_sat;
    T u_star, t_star, q_star, ds;
    surface_conditions(most_constants(a), at, temp, q_eff, &u_star, &t_star, &q_star, &ds);
    T r_s = T(a.von_karman_const) / ds;
    T heat_soil, E_soil, heat_pond, E_pond;
    assemble_fluxes(a, at.rho_a, temp, q_soil, u_star, t_star, (at.q_atm - q_soil) * r_s,
                    &heat_soil, &E_soil);
    assemble_fluxes(a, at.rho_a, temp, q_sat, u_star, t_star, (at.q_atm - q_sat) * r_s,
                    &heat_pond, &E_pond);
    ex.heat_flux = one_m_w * heat_soil + w * heat_pond;
    ex.evap_soil = one_m_w * E_soil;
    ex.evap_pond = w * E_pond;
  }
  return ex;
}

}  // namespace
