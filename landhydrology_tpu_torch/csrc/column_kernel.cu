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
//                     closures drop out.
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
                      const T bc_val[kNumBC], Profiles<T> prof, const T* zc, T dt,
                      T dz, const Coefs<T>& coef) {
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
  rhs_sweep<T, M>(c, a, col, u, bc_val, prof, zc, dz, coef, write);
}

template <typename T, int M>
__global__ void ssprk33_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  const Column<T> c = load_column<T>(a, col, eps, tiny);
  const T dt = T(a.dt), dz = T(a.dz);
  const T* zc = static_cast<const T*>(a.zc);

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
      const Profiles<T> prof = load_profiles<T>(a, row);
      if (s == 0) stage<T, M>(c, a, col, Y, Y, A, 0, bc_val, prof, zc, dt, dz, coef);
      if (s == 1) stage<T, M>(c, a, col, A, Y, B, 1, bc_val, prof, zc, dt, dz, coef);
      if (s == 2) stage<T, M>(c, a, col, B, Y, Y, 2, bc_val, prof, zc, dt, dz, coef);
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
template <typename T>
int dispatch(const KernelArgs* args, int block, void* stream) {
  switch (args->mode) {
    case 0: return launch<T, 0>(args, block, stream);
    case MODE_LAGGED: return launch<T, MODE_LAGGED>(args, block, stream);
    case MODE_NO_ICE: return launch<T, MODE_NO_ICE>(args, block, stream);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int column_kernel_args_size() { return static_cast<int>(sizeof(KernelArgs)); }

int column_kernel_ssprk33_f32(const KernelArgs* args, int block, void* stream) {
  return dispatch<float>(args, block, stream);
}

int column_kernel_ssprk33_f64(const KernelArgs* args, int block, void* stream) {
  return dispatch<double>(args, block, stream);
}

}  // extern "C"
