// The SSPRK33 stage of the explicit column kernels' SSPRK33 instances
// (column_kernel.cu, and land_column.cuh's with fixed stages): one stage's
// rhs sweep and update, with the equilibrium phase projection (kernel B3)
// of column_common.cuh on its last stage.  The stage-table instances
// (rk_kernel.cu, land_column.cuh's others) step through
// column_common.cuh's table_stage.

#pragma once

#include "column_common.cuh"

namespace {

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
