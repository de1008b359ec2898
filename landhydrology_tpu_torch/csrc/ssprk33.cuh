// The SSPRK33 stage of the explicit column kernels (column_kernel.cu,
// land_kernel.cu): one stage's rhs sweep and update, the lagged coefficient
// pass (kernel B2) and the equilibrium phase projection (kernel B3).

#pragma once

#include "column_common.cuh"

namespace {

// ---- freeze_thaw.py: the equilibrium projection ----

// (theta_l, theta_i) on the equilibrium manifold at T, for water mass w.
template <typename T>
__device__ void phase_partition(const Column<T>& c, T w, T temp, T* theta_l, T* ti) {
  T theta_l_max = equilibrium_unfrozen_liquid(c, temp);
  *theta_l = temp >= c.T_0 ? w : d_min(w, theta_l_max);
  *ti = c.rho_l_over_i * (w - *theta_l);
}

template <typename T>
__device__ T phase_residual(const Column<T>& c, T w, T e, T temp) {
  T theta_l, ti;
  phase_partition(c, w, temp, &theta_l, &ti);
  T theta_l_cap = d_min(theta_l, c.p[P_NU] - ti);
  T rho_c_s = rn_add(rn_add(c.p[P_RHO_C_DS], rn_mul(theta_l_cap, c.rho_cp_l)),
                     rn_mul(ti, c.rho_cp_i));
  return rn_sub(rn_sub(rn_mul(rho_c_s, temp - c.T_0),
                       rn_mul(rn_mul(ti, c.rho_ice), c.LH_f0)),
                e);
}

// equilibrium_phase_projection of one cell; rho_e_int is unchanged.
template <typename T>
__device__ void phase_projection(const Column<T>& c, T* vl, T* ti, T e) {
  const T w = rn_add(*vl, rn_mul(c.rho_i_over_l, *ti));
  T lo = c.T_lo, hi = c.T_hi;
  T f_lo = phase_residual(c, w, e, lo);
  for (int64_t i = 0; i < c.n_iter; ++i) {
    T mid = T(0.5) * (lo + hi);
    T f_mid = phase_residual(c, w, e, mid);
    bool same = f_mid * f_lo > T(0);
    lo = same ? mid : lo;
    hi = same ? hi : mid;
    f_lo = same ? f_mid : f_lo;
  }
  T theta_l, theta_i;
  phase_partition(c, w, T(0.5) * (lo + hi), &theta_l, &theta_i);
  *vl = theta_l;
  *ti = d_max(theta_i, T(0));
}

// lagged.py::compute_coeffs over one column, from the step's start state.
template <typename T, int M>
__device__ void coefficients(const Column<T>& c, const KernelArgs& a, int64_t col,
                             const T* vl_in, const T* ti_in, const T* re_in,
                             const Coefs<T>& coef) {
  for (int64_t k = 0; k < a.nz; ++k) {
    const int64_t i = k * a.ncol + col;
    T vl = vl_in[i], ti = ti_in[i], re = re_in[i];
    T theta_l = d_min(vl, Modes<M>::no_ice ? c.p[P_NU] : c.p[P_NU] - ti);
    T temp, kappa, rho_c_s, K;
    closures<T, M>(c, vl, ti, re, theta_l, &temp, &kappa, &rho_c_s, &K);
    coef.K[i] = K;
    coef.kappa[i] = kappa;
    coef.inv_rho_c_s[i] = T(1) / rho_c_s;
    coef.KE[i] = c.rho_cp_l * (temp - c.T_0) * K;
    if (Modes<M>::rate) coef.rho_c_s[i] = rho_c_s;
  }
}

// One SSPRK33 stage for one column: out = a_y * y + a_u * (u + dt * f(u)),
// with stage 0 writing u + dt * f(u) alone; MODE_FREEZE_EQ projects the
// cells stage 2 writes.  The fields a branch lacks are left alone.
template <typename T, int M>
__device__ void stage(const Column<T>& c, const KernelArgs& a, int64_t col,
                      Fields<T> u, Fields<T> y, Fields<T> out, int s,
                      const T bc_val[kNumBC], const Profiles<T, M>& prof, const Grid<T, M>& g,
                      T dt, const Coefs<T>& coef) {
  const int64_t ncol = a.ncol;
  T a_y = s == 1 ? T(0.75) : T(1.0 / 3.0);
  T a_u = s == 1 ? T(0.25) : T(2.0 / 3.0);
  constexpr bool has_water = !Modes<M>::heat, has_heat = !Modes<M>::water;

  auto write = [&](int64_t k, const Center<T>& x, T d_vl, T d_ti, T d_re) {
    const int64_t i = k * ncol + col;
    T n_vl = x.vl + dt * d_vl;
    T n_ti = x.ti + dt * d_ti;
    T n_re = x.re + dt * d_re;
    if (s == 0) {
      if (has_water) {
        out.vl[i] = n_vl;
        out.ti[i] = n_ti;
      }
      if (has_heat) out.re[i] = n_re;
      return;
    }
    if (has_water) {
      n_vl = a_y * y.vl[i] + a_u * n_vl;
      n_ti = a_y * y.ti[i] + a_u * n_ti;
    }
    if (has_heat) n_re = a_y * y.re[i] + a_u * n_re;
    if (Modes<M>::eq && s == 2) phase_projection(c, &n_vl, &n_ti, n_re);
    if (has_water) {
      out.vl[i] = n_vl;
      out.ti[i] = n_ti;
    }
    if (has_heat) out.re[i] = n_re;
  };
  rhs_sweep<T, M>(c, a, col, u, bc_val, prof, g, coef, write);
}

}  // namespace
