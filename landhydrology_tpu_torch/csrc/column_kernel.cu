// Fused multi-step soil-column kernel: SSPRK33 steps of the coupled
// water + energy tendency, one thread per column.
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::make_fused_column_run
// in its explicit SSPRK33 modes: the coupled branch of
// landhydrology_tpu/models/soil/rhs.py with the boundary.py flux conversion,
// advanced by timestepping.py::SSPRK33, `n_steps` steps per launch, in place.
// The mode word (enum Mode, a template parameter) adds, at compile time:
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
//
// Numerics follow the eager PyTorch port (landhydrology_tpu_torch) operation
// for operation.  eps and tiny are numeric_limits<T>::epsilon() / min()
// (jnp.finfo(dtype).eps / .tiny).  Clamps use fmin/fmax, which return the
// non-NaN operand where jnp.minimum/maximum would propagate a NaN; the two
// differ only for NaN inputs.  Built without --use_fast_math.  The
// freeze-thaw residual and partition are written with the _rn intrinsics,
// which nvcc never contracts into a fused multiply-add: the bisection
// branches on the residual's sign, so it is evaluated as the eager version
// evaluates it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <limits>

// Types of the C interface: outside the unnamed namespace, so the extern "C"
// entry points that take them keep external linkage.

// Order fixed by PARAM_NAMES in ops/cuda/column_kernel.py.
enum Param {
  P_NU, P_S_S, P_RHO_C_DS, P_THETA_R, P_KSAT, P_M, P_INV_M, P_NEG_INV_M,
  P_INV_N, P_ALPHA_POW_NEG_N, P_LN_KAPPA_SAT_UNFROZEN, P_LN_KAPPA_SAT_FROZEN,
  P_KAPPA_DRY, P_NEG_B, P_KERSTEN_EXP_UNFROZEN, P_KERSTEN_EXP_BRACKET,
  P_KERSTEN_EXP_FROZEN, P_VISC_GAMMA, P_VISC_T_REF, P_IMPEDANCE_COEF,
  P_KAPPA_SAT_UNFROZEN, P_ALPHA, P_N, P_TAU,
  kNumParams
};

// Order fixed by BC_SLOTS in ops/cuda/column_kernel.py.
enum BCSlot { BC_BOTTOM_ENERGY, BC_BOTTOM_HYDROLOGY, BC_TOP_ENERGY,
              BC_TOP_HYDROLOGY, kNumBC };
enum BCKind : int64_t { BC_FLUX = 1, BC_DIRICHLET = 2, BC_FREE_DRAINAGE = 3 };

// Bits of KernelArgs::mode; values fixed by MODE_* in ops/cuda/column_kernel.py.
enum Mode : int64_t {
  MODE_LAGGED = 1, MODE_FREEZE_RATE = 2, MODE_FREEZE_EQ = 4, MODE_NO_ICE = 8
};

// Every field is 8 bytes wide: mirrors _KernelArgs in ops/cuda/column_kernel.py.
struct KernelArgs {
  void* vartheta_l;  // (nz, ncol) in/out
  void* theta_i;     // (nz, ncol) in/out
  void* rho_e_int;   // (nz, ncol) in/out
  void* scratch;     // the two SSPRK33 stage states (6 * nz * ncol), then
                     // the lagged coefficients (4 or 5 * nz * ncol)
  const void* zc;    // (nz,) cell centers
  const void* param_ptr[kNumParams];
  int64_t param_stride[kNumParams];  // 0: one value for all columns
  const void* bc_ptr[kNumBC];        // value tables, row = 3 * step + stage
  int64_t bc_kind[kNumBC];
  int64_t bc_row_stride[kNumBC];
  int64_t bc_col_stride[kNumBC];
  int64_t nz, ncol, n_steps, viscosity, impedance, mode, n_iter;
  double dt, dz;
  double T_0, rho_cloud_ice, LH_f0, rho_cp_l, rho_cp_i, rho_cloud_liq, grav;
  double T_lo, T_hi;  // EquilibriumFreezeThaw bracket
};

namespace {

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_log(float x) { return logf(x); }
__device__ __forceinline__ double d_log(double x) { return log(x); }
__device__ __forceinline__ float d_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double d_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ float d_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double d_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float d_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double d_max(double a, double b) { return fmax(a, b); }
// rounded operations that are never contracted into a fused multiply-add
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }

// Per-column constants and Earth constants, in the working type.
template <typename T>
struct Column {
  T p[kNumParams];
  T T_0, rho_ice, LH_f0, rho_cp_l, rho_cp_i;
  // freeze-thaw: rho_i/rho_l, rho_l/rho_i and rho_i LH_f0 as the eager
  // version rounds them (double, then the working type); g; the bracket
  T rho_i_over_l, rho_l_over_i, rho_i_LH_f0, grav, T_lo, T_hi;
  int64_t n_iter;
  T eps, tiny;  // numeric_limits<T>::epsilon() and min(), set by launch()
  bool viscosity, impedance;
};

template <typename T>
struct Center {
  T vl, ti, re;     // stage state
  T temp, kappa;    // T and kappa
  T K, psi, h;      // conductivity, pressure head, h = psi + z
  T reK;            // rho_e_int_l * K
  T src_l, src_i;   // phase-change sources (MODE_FREEZE_RATE)
};

// The lagged coefficients, (nz, ncol) each, in the scratch buffer.
template <typename T>
struct Coefs {
  T* K;
  T* kappa;
  T* inv_rho_c_s;
  T* KE;
  T* rho_c_s;  // MODE_FREEZE_RATE only
};

template <typename T> __device__ __forceinline__ T clip_unit(const Column<T>& c, T S) {
  return d_min(d_max(S, c.eps), T(1) - c.eps);
}

// ---- water.py ----

template <typename T>
__device__ T effective_saturation(const Column<T>& c, T porosity, T vl) {
  T theta_r = c.p[P_THETA_R];
  T safe = d_max(vl, theta_r + c.eps);
  return (safe - theta_r) / (porosity - theta_r);
}

template <typename T>
__device__ T matric_potential(const Column<T>& c, T S) {
  T S_safe = clip_unit(c, S);
  T u_inv = d_exp(d_log(S_safe) * c.p[P_NEG_INV_M]);
  T base = (u_inv - T(1)) * c.p[P_ALPHA_POW_NEG_N];
  T psi_unsat = -d_exp(d_log(d_max(base, c.tiny)) * c.p[P_INV_N]);
  return S < T(1) ? psi_unsat : T(0);
}

template <typename T>
__device__ T pressure_head(const Column<T>& c, T vl, T nu_eff) {
  T S = effective_saturation(c, nu_eff, vl);
  T psi_unsat = matric_potential(c, S);
  T psi_sat = (vl - nu_eff) / c.p[P_S_S];
  return S <= T(1) ? psi_unsat : psi_sat;
}

template <typename T>
__device__ T hydraulic_conductivity(const Column<T>& c, T S, T visc, T imp) {
  T S_safe = clip_unit(c, S);
  T u = d_exp(d_log(S_safe) * c.p[P_INV_M]);
  T f = T(1) - d_exp(d_log(d_max(T(1) - u, c.tiny)) * c.p[P_M]);
  T K_unsat = d_sqrt(S_safe) * f * f;
  T K = S < T(1) ? K_unsat : T(1);
  return K * c.p[P_KSAT] * visc * imp;
}

template <typename T>
__device__ T ice_fraction(const Column<T>& c, T theta_l, T ti) {
  return ti * (T(1) / d_max(theta_l + ti, c.eps));
}

template <typename T>
__device__ T viscosity_factor(const Column<T>& c, T temp) {
  return c.viscosity ? d_exp(c.p[P_VISC_GAMMA] * (temp - c.p[P_VISC_T_REF])) : T(1);
}

template <typename T>
__device__ T impedance_factor(const Column<T>& c, T f_i) {
  return c.impedance ? d_exp(c.p[P_IMPEDANCE_COEF] * f_i) : T(1);
}

// K from (vartheta_l, theta_i, T): hydrology_center_fields / free drainage.
template <typename T>
__device__ T conductivity(const Column<T>& c, T vl, T ti, T temp) {
  T theta_l = d_min(vl, c.p[P_NU] - ti);
  T imp = impedance_factor(c, ice_fraction(c, theta_l, ti));
  T visc = viscosity_factor(c, temp);
  T S = effective_saturation(c, c.p[P_NU], vl);
  return hydraulic_conductivity(c, S, visc, imp);
}

// The same with assume_no_ice: the impedance factor is one.
template <typename T>
__device__ T conductivity_no_ice(const Column<T>& c, T vl, T temp) {
  T visc = viscosity_factor(c, temp);
  T S = effective_saturation(c, c.p[P_NU], vl);
  return hydraulic_conductivity(c, S, visc, T(1));
}

// ---- heat.py ----

template <typename T>
__device__ T kersten_number(const Column<T>& c, T ti, T S_r) {
  T S_r_safe = d_max(S_r, T(0));
  T half = (T(1) - S_r_safe) / T(2);
  T t = T(1) + d_exp(c.p[P_NEG_B] * S_r_safe);
  T bracket = T(1) / (t * t * t) - half * half * half;
  T ln_S = d_log(d_max(S_r_safe, c.tiny));
  T ln_bracket = d_log(d_max(bracket, c.tiny));
  T unfrozen = d_exp(ln_S * c.p[P_KERSTEN_EXP_UNFROZEN] +
                     ln_bracket * c.p[P_KERSTEN_EXP_BRACKET]);
  if (ti < c.eps) return unfrozen;
  return d_exp(ln_S * c.p[P_KERSTEN_EXP_FROZEN]);
}

template <typename T>
__device__ T saturated_thermal_conductivity(const Column<T>& c, T theta_l, T ti) {
  T theta_w = theta_l + ti;
  T r_theta_w = T(1) / d_max(theta_w, c.eps);
  T kappa = d_exp((theta_l * c.p[P_LN_KAPPA_SAT_UNFROZEN] +
                   ti * c.p[P_LN_KAPPA_SAT_FROZEN]) * r_theta_w);
  return theta_w < c.eps ? T(0) : kappa;
}

// kappa from (vartheta_l, theta_i): energy_center_fields / Dirichlet face.
template <typename T>
__device__ T thermal_conductivity(const Column<T>& c, T vl, T ti) {
  T theta_l = d_min(vl, c.p[P_NU] - ti);
  T S_r = (theta_l + ti) / c.p[P_NU];
  T Ke = kersten_number(c, ti, S_r);
  T kappa_sat = saturated_thermal_conductivity(c, theta_l, ti);
  return Ke * kappa_sat + (T(1) - Ke) * c.p[P_KAPPA_DRY];
}

// The same with assume_no_ice: unfrozen Kersten branch, kappa_sat unfrozen.
template <typename T>
__device__ T thermal_conductivity_no_ice(const Column<T>& c, T theta_l) {
  T S_r = theta_l / c.p[P_NU];
  T Ke = kersten_number(c, T(0), S_r);
  T kappa_sat = theta_l < c.eps ? T(0) : c.p[P_KAPPA_SAT_UNFROZEN];
  return Ke * kappa_sat + (T(1) - Ke) * c.p[P_KAPPA_DRY];
}

// ---- freeze_thaw.py ----

// theta_l_max(T): +inf at and above T_0.
template <typename T>
__device__ T equilibrium_unfrozen_liquid(const Column<T>& c, T temp) {
  T T_safe = d_max(temp, T(200));
  T psi_f = c.LH_f0 * (d_min(T_safe, c.T_0) - c.T_0) / (c.grav * T_safe);
  T S_max = d_pow(T(1) + d_pow(c.p[P_ALPHA] * d_abs(psi_f), c.p[P_N]), -c.p[P_M]);
  T theta_r = c.p[P_THETA_R];
  T theta_l_max = rn_add(theta_r, rn_mul(c.p[P_NU] - theta_r, S_max));
  return temp >= c.T_0 ? T(INFINITY) : theta_l_max;
}

template <typename T>
__device__ void phase_change_sources(const Column<T>& c, T theta_l, T ti, T temp,
                                     T rho_c_s, T* src_l, T* src_i) {
  T theta_l_max = equilibrium_unfrozen_liquid(c, temp);
  T excess = isinf(theta_l_max) ? T(0) : d_max(theta_l - theta_l_max, T(0));
  T deficit_ice = d_max(rho_c_s * (c.T_0 - temp), T(0)) / c.rho_i_LH_f0;
  T surplus_ice = d_max(rho_c_s * (temp - c.T_0), T(0)) / c.rho_i_LH_f0;
  T freeze_ice = d_min(c.rho_l_over_i * excess, deficit_ice) / c.p[P_TAU];
  T melt_ice = d_min(ti, surplus_ice) / c.p[P_TAU];
  *src_i = freeze_ice - melt_ice;
  *src_l = c.rho_i_over_l * (melt_ice - freeze_ice);
}

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

// ---- rhs.py: the coupled center sweep ----

template <int M> struct Modes {
  static constexpr bool lagged = (M & MODE_LAGGED) != 0;
  static constexpr bool rate = (M & MODE_FREEZE_RATE) != 0;
  static constexpr bool eq = (M & MODE_FREEZE_EQ) != 0;
  static constexpr bool no_ice = (M & MODE_NO_ICE) != 0;
};

// energy_center_fields: T, kappa and rho_c_s at a center, and K
// (hydrology_center_fields), from the state.
template <typename T, int M>
__device__ void closures(const Column<T>& c, T vl, T ti, T re, T theta_l,
                         T* temp, T* kappa, T* rho_c_s, T* K) {
  if (Modes<M>::no_ice) {
    *rho_c_s = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l;
    *temp = c.T_0 + re / *rho_c_s;
    *kappa = thermal_conductivity_no_ice(c, theta_l);
    *K = conductivity_no_ice(c, vl, *temp);
  } else {
    *rho_c_s = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l + ti * c.rho_cp_i;
    *temp = c.T_0 + (re + ti * c.rho_ice * c.LH_f0) / *rho_c_s;
    *kappa = thermal_conductivity(c, vl, ti);
    *K = conductivity(c, vl, ti, *temp);
  }
}

// The center fields of one stage.  Stage coefficients evaluate the closures
// here; lagged ones read them from `coef` at index i and diagnose T through
// the frozen reciprocal heat capacity.
template <typename T, int M>
__device__ Center<T> center_fields(const Column<T>& c, const Coefs<T>& coef,
                                   int64_t i, T vl, T ti, T re, T z) {
  Center<T> x;
  x.vl = vl;
  x.ti = ti;
  x.re = re;
  T nu_eff = Modes<M>::no_ice ? c.p[P_NU] : c.p[P_NU] - ti;
  T theta_l = d_min(vl, nu_eff);
  T rho_c_s;
  if (Modes<M>::lagged) {
    T inv_rho_c_s = coef.inv_rho_c_s[i];
    x.temp = Modes<M>::no_ice
                 ? c.T_0 + re * inv_rho_c_s
                 : c.T_0 + (re + ti * c.rho_ice * c.LH_f0) * inv_rho_c_s;
    x.kappa = coef.kappa[i];
    x.K = coef.K[i];
    x.reK = coef.KE[i];
    rho_c_s = Modes<M>::rate ? coef.rho_c_s[i] : T(0);
  } else {
    closures<T, M>(c, vl, ti, re, theta_l, &x.temp, &x.kappa, &rho_c_s, &x.K);
    T rho_e_int_l = c.rho_cp_l * (x.temp - c.T_0);
    x.reK = rho_e_int_l * x.K;
  }
  x.psi = pressure_head(c, vl, nu_eff);
  x.h = x.psi + z;
  if (Modes<M>::rate) {
    phase_change_sources(c, theta_l, ti, x.temp, rho_c_s, &x.src_l, &x.src_i);
  } else {
    x.src_l = T(0);
    x.src_i = T(0);
  }
  return x;
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

// ---- boundary.py: boundary_fluxes at one face ----
// The Dirichlet values of both components overwrite the face state before
// either flux is computed.  The boundary fluxes are never lagged: free
// drainage takes K of the stage state (`live_K`) in the lagged mode.
template <typename T>
__device__ void face_fluxes(const Column<T>& c, const Center<T>& x,
                            int64_t kind_e, T val_e, int64_t kind_w, T val_w,
                            bool top, bool live_K, T dzb, T* f_e, T* f_w) {
  T vl_f = kind_w == BC_DIRICHLET ? val_w : x.vl;
  T temp_f = kind_e == BC_DIRICHLET ? val_e : x.temp;
  T ti_f = x.ti;
  if (kind_e == BC_FLUX) {
    *f_e = val_e;
  } else {  // Dirichlet
    T kappa_f = thermal_conductivity(c, vl_f, ti_f);
    T flux = (-kappa_f) * (temp_f - x.temp) / dzb;
    *f_e = top ? flux : -flux;
  }
  if (kind_w == BC_FLUX) {
    *f_w = val_w;
  } else if (kind_w == BC_FREE_DRAINAGE) {
    *f_w = -(live_K ? conductivity(c, x.vl, x.ti, x.temp) : x.K);
  } else {  // Dirichlet
    T K_f = conductivity(c, vl_f, ti_f, temp_f);
    T psi_f = pressure_head(c, vl_f, c.p[P_NU] - ti_f);
    *f_w = top ? (-K_f) * (psi_f - x.psi + dzb) / dzb
               : (-K_f) * (x.psi - psi_f + dzb) / dzb;
  }
}

template <typename T>
struct Fields {
  T* vl;
  T* ti;
  T* re;
};

// One SSPRK33 stage for one column: out = a_y * y + a_u * (u + dt * f(u)),
// with stage 0 writing u + dt * f(u) alone; MODE_FREEZE_EQ projects the
// cells stage 2 writes.
template <typename T, int M>
__device__ void stage(const Column<T>& c, const KernelArgs& a, int64_t col,
                      Fields<T> u, Fields<T> y, Fields<T> out, int s,
                      const T bc_val[kNumBC], const T* zc, T dt, T dz,
                      const Coefs<T>& coef) {
  const int64_t nz = a.nz, ncol = a.ncol;
  const T dzb = dz / T(2);
  T a_y = s == 1 ? T(0.75) : T(1.0 / 3.0);
  T a_u = s == 1 ? T(0.25) : T(2.0 / 3.0);

  auto write = [&](int64_t k, const Center<T>& x, T dF_w, T dF_e) {
    const int64_t i = k * ncol + col;
    T d_vl = -(dF_w / dz);
    T d_ti = T(0);
    if (Modes<M>::rate) {
      d_vl = d_vl + x.src_l;
      d_ti = d_ti + x.src_i;
    }
    T d_re = -(dF_e / dz);
    T n_vl = x.vl + dt * d_vl;
    T n_ti = x.ti + dt * d_ti;
    T n_re = x.re + dt * d_re;
    if (s == 0) {
      out.vl[i] = n_vl;
      out.ti[i] = n_ti;
      out.re[i] = n_re;
      return;
    }
    T o_vl = a_y * y.vl[i] + a_u * n_vl;
    T o_ti = a_y * y.ti[i] + a_u * n_ti;
    T o_re = a_y * y.re[i] + a_u * n_re;
    if (Modes<M>::eq && s == 2) phase_projection(c, &o_vl, &o_ti, o_re);
    out.vl[i] = o_vl;
    out.ti[i] = o_ti;
    out.re[i] = o_re;
  };

  Center<T> prev;
  T Fw_prev = T(0), Fe_prev = T(0);
  for (int64_t k = 0; k < nz; ++k) {
    const int64_t i = k * ncol + col;
    Center<T> x = center_fields<T, M>(c, coef, i, u.vl[i], u.ti[i], u.re[i], zc[k]);
    if (k == 0) {
      face_fluxes(c, x, a.bc_kind[BC_BOTTOM_ENERGY], bc_val[BC_BOTTOM_ENERGY],
                  a.bc_kind[BC_BOTTOM_HYDROLOGY], bc_val[BC_BOTTOM_HYDROLOGY],
                  false, Modes<M>::lagged, dzb, &Fe_prev, &Fw_prev);
    } else {
      // interior face between centers k-1 and k: -interp(coef) * grad
      T grad_h = (x.h - prev.h) / dz;
      T Fw = (-(T(0.5) * (prev.K + x.K))) * grad_h;
      T Fe = (-(T(0.5) * (prev.kappa + x.kappa))) * ((x.temp - prev.temp) / dz) +
             (-(T(0.5) * (prev.reK + x.reK))) * grad_h;
      write(k - 1, prev, Fw - Fw_prev, Fe - Fe_prev);
      Fw_prev = Fw;
      Fe_prev = Fe;
    }
    prev = x;
  }
  T Fe_top, Fw_top;
  face_fluxes(c, prev, a.bc_kind[BC_TOP_ENERGY], bc_val[BC_TOP_ENERGY],
              a.bc_kind[BC_TOP_HYDROLOGY], bc_val[BC_TOP_HYDROLOGY], true,
              Modes<M>::lagged, dzb, &Fe_top, &Fw_top);
  write(nz - 1, prev, Fw_top - Fw_prev, Fe_top - Fe_prev);
}

template <typename T, int M>
__global__ void ssprk33_column_kernel(const KernelArgs a, T eps, T tiny) {
  const int64_t col = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= a.ncol) return;  // ragged last block

  Column<T> c;
  for (int j = 0; j < kNumParams; ++j) {
    c.p[j] = static_cast<const T*>(a.param_ptr[j])[col * a.param_stride[j]];
  }
  c.T_0 = T(a.T_0);
  c.rho_ice = T(a.rho_cloud_ice);
  c.LH_f0 = T(a.LH_f0);
  c.rho_cp_l = T(a.rho_cp_l);
  c.rho_cp_i = T(a.rho_cp_i);
  c.rho_i_over_l = T(a.rho_cloud_ice / a.rho_cloud_liq);
  c.rho_l_over_i = T(a.rho_cloud_liq / a.rho_cloud_ice);
  c.rho_i_LH_f0 = T(a.rho_cloud_ice * a.LH_f0);
  c.grav = T(a.grav);
  c.T_lo = T(a.T_lo);
  c.T_hi = T(a.T_hi);
  c.n_iter = a.n_iter;
  c.eps = eps;
  c.tiny = tiny;
  c.viscosity = a.viscosity != 0;
  c.impedance = a.impedance != 0;
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
      T bc_val[kNumBC];
      for (int j = 0; j < kNumBC; ++j) {
        bc_val[j] = a.bc_kind[j] == BC_FREE_DRAINAGE
                        ? T(0)
                        : static_cast<const T*>(a.bc_ptr[j])[
                              (3 * step + s) * a.bc_row_stride[j] +
                              col * a.bc_col_stride[j]];
      }
      if (s == 0) stage<T, M>(c, a, col, Y, Y, A, 0, bc_val, zc, dt, dz, coef);
      if (s == 1) stage<T, M>(c, a, col, A, Y, B, 1, bc_val, zc, dt, dz, coef);
      if (s == 2) stage<T, M>(c, a, col, B, Y, Y, 2, bc_val, zc, dt, dz, coef);
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
// freeze-thaw, and the two freeze-thaw schemes exclude each other.
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
