// Device code shared by the soil-column kernels (column_kernel.cu, the
// implicit_*.cu sources of implicit_column.cuh, the land_*.cu sources of
// land_column.cuh, and rk_kernel.cu and rk_columns_kernel.cu of
// rk_column.cuh): the argument struct of the C interface, the pointwise
// closures of models/soil/water.py, heat.py and freeze_thaw.py, the boundary
// flux conversion of boundary.py, one rhs sweep of rhs.py over a column, and
// one stage of the explicit steppers' stage table (rk_column.cuh and
// land_column.cuh).
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

#pragma once

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
  P_KAPPA_SAT_UNFROZEN, P_ALPHA, P_N, P_TAU, P_N_M,
  kNumParams
};

// Order fixed by BC_SLOTS in ops/cuda/column_kernel.py.
enum BCSlot { BC_BOTTOM_ENERGY, BC_BOTTOM_HYDROLOGY, BC_TOP_ENERGY,
              BC_TOP_HYDROLOGY, kNumBC };
// BC_NONE: the slot of a prescribed component, which has no flux.
// BC_BATCHED: a BatchedBC slot (kernel mode B1-batched), whose columns each
// name one of the first three kinds in KernelArgs::bc_kind_col.  The host
// maps the package's BCKind codes (FLUX 0, DIRICHLET 1, FREE_DRAINAGE 2)
// onto these once, per column (cuda_kind_codes in ops/cuda/column_kernel.py).
enum BCKind : int64_t { BC_NONE = 0, BC_FLUX = 1, BC_DIRICHLET = 2, BC_FREE_DRAINAGE = 3,
                        BC_BATCHED = 4 };

// Order fixed by PROFILE_NAMES in ops/cuda/column_kernel.py: the prescribed
// T (water-only branch), vartheta_l and theta_i (heat-only branch).
enum Profile { PROF_T, PROF_VARTHETA_L, PROF_THETA_I, kNumProfiles };

// Order fixed by SURFACE_NAMES in ops/cuda/column_kernel.py: the inputs of
// the surface exchange (land_kernel.cu), each a value table like a BC's.
enum Surface {
  S_U_ATM, S_THETA_ATM, S_Z_ATM, S_THETA_SCALE, S_RHO_A_SFC, S_Q_ATM, S_Z_0M, S_Z_0S,
  S_TAU_POND, S_H_EVAP_SMOOTHING,
  kNumSurface
};

// Bits of KernelArgs::mode; values fixed by MODE_* in ops/cuda/column_kernel.py.
// Branch: MODE_WATER (Richards only) or MODE_HEAT (conduction only), coupled
// without either.  Stepper: SSPRK33 (column_kernel.cu) without a stepper
// bit, one of the implicit steppers (implicit_kernel.cu), or ForwardEuler,
// SSPRK22 or SSPRK104 (rk_kernel.cu, which also runs SSPRK33 with lagged
// coefficients or assume_no_ice on the water-only and heat-only branches).
// MODE_PCR and the explicit stepper bits are read at run time and select no
// template instance.  Surface (land_kernel.cu):
// MODE_MOST (a PrescribedAtmosForcing top), MODE_LAND (the LandModel pond),
// MODE_SURFACE_STEP (its exchange frozen per step).  MODE_COLUMNS: the run
// reads per-column BC kinds (kernel mode B1-batched) and/or a per-column
// grid and profile tables (B8) at run time; without it an instance reads
// one kind per slot, one spacing and (nz,) centers and profile rows, as
// before those modes existed, in as few registers.
enum Mode : int64_t {
  MODE_LAGGED = 1, MODE_FREEZE_RATE = 2, MODE_FREEZE_EQ = 4, MODE_NO_ICE = 8,
  MODE_WATER = 16, MODE_HEAT = 32,
  MODE_BE_RICHARDS = 64, MODE_BE_SOIL = 128, MODE_TRBDF2 = 256,
  MODE_PCR = 512,
  MODE_MOST = 1024, MODE_LAND = 2048, MODE_SURFACE_STEP = 4096,
  MODE_COLUMNS = 8192,
  MODE_EULER = 16384, MODE_SSPRK22 = 32768, MODE_SSPRK104 = 65536,
  // Never in the host's mode word: the sources set it on their no-ice
  // instances (every rk_kernel.cu instance carries it).  With it,
  // assume_no_ice caps theta_l at nu - theta_i for the closures of the stage
  // rhs, as rhs.py does; without it at nu (column_kernel.cu's B2-no-ice,
  // whose lagged closures cap at nu as lagged.py's do, and which reads the
  // stage theta_l only for rate sources, which no ice excludes).
  MODE_RHS_CAP = 131072
};

// The explicit Runge-Kutta stages of rk_kernel.cu and land_column.cuh (the
// stage table, table_stage below): at most kMaxStages per step, each
// n = u + h f(u) of the register it reads, then (StageKind)
//   STAGE_AXPY   out = n
//   STAGE_COMB   out = a_y aux + a_u n              (c = h, a_y, a_u)
//   STAGE_SPLIT  aux = c1 Y + c2 n; out = c3 aux + c4 n   (SSPRK104's q2, q1)
//   STAGE_FINAL  out = (aux + c1 u) + h f(u)         (SSPRK104's last stage)
// Registers: 0 the state, 1 and 2 the two scratch states.
constexpr int kMaxStages = 10;
enum StageKind : int64_t { STAGE_AXPY = 0, STAGE_COMB = 1, STAGE_SPLIT = 2, STAGE_FINAL = 3 };

// Every field is 8 bytes wide: mirrors _KernelArgs in ops/cuda/column_kernel.py.
struct KernelArgs {
  void* vartheta_l;  // (nz, ncol) in/out; null in the heat-only branch
  void* theta_i;     // (nz, ncol) in/out; null in the heat-only branch
  void* rho_e_int;   // (nz, ncol) in/out; null in the water-only branch
  void* scratch;     // scratch_fields(mode) * nz * ncol values
  const void* zc;    // cell centers: level k of column col at zc_level_stride k + zc_col_stride col
  const void* param_ptr[kNumParams];
  int64_t param_stride[kNumParams];  // 0: one value for all columns
  const void* bc_ptr[kNumBC];        // value tables, row = rows_per_step * step + stage
  int64_t bc_kind[kNumBC];
  int64_t bc_row_stride[kNumBC];
  int64_t bc_col_stride[kNumBC];
  int64_t nz, ncol, n_steps, viscosity, impedance, mode, n_iter;
  double dt, dz;  // dz: the spacing of every column unless dz_col is set
  double T_0, rho_cloud_ice, LH_f0, rho_cp_l, rho_cp_i, rho_cloud_liq, grav;
  double T_lo, T_hi;  // EquilibriumFreezeThaw bracket
  const void* profile[kNumProfiles];  // value tables (strides below), or null
  int64_t rows_per_step;              // table rows per step: one per stage time
  int64_t iters;                      // Newton sweeps per stage (implicit)
  double half_g, a1, a2, b_bdf2;      // TR-BDF2 constants, in double
  // the surface exchange (land_kernel.cu): value tables, row = as bc_ptr's
  const void* surface_ptr[kNumSurface];
  int64_t surface_row_stride[kNumSurface];
  int64_t surface_col_stride[kNumSurface];
  const void* precip;  // rain rate: row = as bc_ptr's, or the forcing row
  void* h_s;           // (ncol,) pond height, in/out
  double von_karman_const, cp_d, cp_v, cp_l, R_d, R_v, LH_v0, press_triple, T_triple,
      molmass_ratio;
  // streamed forcing rows (land_kernel.cu, kernel B7): bit j of `forced` set
  // reads surface input j, and bit kNumSurface the rain rate, at the step's
  // forcing row (for all three stages) instead of the stage row
  int64_t forced;
  int64_t frow_mode;  // FROW_NONE, FROW_STEP (row = step) or FROW_TIME
  int64_t n_frows;    // rows of a time-indexed table
  int64_t precip_row_stride, precip_col_stride;
  // the launch's start time and the time grid of FROW_TIME, each a value of
  // the model dtype held in a double
  double t0, t_forcing0, inv_dt_forcing;
  // per-column BC kinds (kernel mode B1-batched): a BC_BATCHED slot j reads
  // the kind of column col at bc_kind_col[j][col * bc_kind_col_stride[j]],
  // int32 codes of enum BCKind
  const void* bc_kind_col[kNumBC];
  int64_t bc_kind_col_stride[kNumBC];
  // per-column geometry (kernel mode B8): the spacing of column col is
  // dz_col[col * dz_col_stride] where dz_col is set; see zc for the centers
  const void* dz_col;
  int64_t dz_col_stride, zc_level_stride, zc_col_stride;
  // profile j's value at table row r, level k, column col is
  // profile[j][r * row + k * level + col * col_stride] (row 0 for a profile
  // that does not depend on time; col_stride 0 for one value per level)
  int64_t profile_row_stride[kNumProfiles];
  int64_t profile_level_stride[kNumProfiles];
  int64_t profile_col_stride[kNumProfiles];
  // the explicit stages of rk_kernel.cu: register read, register written,
  // auxiliary register and StageKind of stage s, and its coefficients at
  // stage_c[5 s + j] (h, then the kind's; each a value of the model dtype
  // held in a double)
  int64_t n_stages;
  int64_t stage_in[kMaxStages], stage_out[kMaxStages], stage_aux[kMaxStages], stage_kind[kMaxStages];
  double stage_c[5 * kMaxStages];
};

// Values of KernelArgs::frow_mode.
enum ForcingRows : int64_t { FROW_NONE = 0, FROW_STEP = 1, FROW_TIME = 2 };

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
// truncation toward zero to int, saturating outside its range (NaN gives 0)
__device__ __forceinline__ int trunc_int(float x) { return __float2int_rz(x); }
__device__ __forceinline__ int trunc_int(double x) { return __double2int_rz(x); }

template <int M> struct Modes {
  static constexpr bool lagged = (M & MODE_LAGGED) != 0;
  static constexpr bool rate = (M & MODE_FREEZE_RATE) != 0;
  static constexpr bool eq = (M & MODE_FREEZE_EQ) != 0;
  static constexpr bool no_ice = (M & MODE_NO_ICE) != 0;
  static constexpr bool water = (M & MODE_WATER) != 0;  // Richards only
  static constexpr bool heat = (M & MODE_HEAT) != 0;    // conduction only
  static constexpr bool coupled = !water && !heat;
  static constexpr bool be_richards = (M & MODE_BE_RICHARDS) != 0;
  static constexpr bool be_soil = (M & MODE_BE_SOIL) != 0;
  static constexpr bool trbdf2 = (M & MODE_TRBDF2) != 0;
  static constexpr bool most = (M & MODE_MOST) != 0;
  static constexpr bool land = (M & MODE_LAND) != 0;
  static constexpr bool surface_step = (M & MODE_SURFACE_STEP) != 0;
  static constexpr bool columns = (M & MODE_COLUMNS) != 0;  // B1-batched, B8
  static constexpr bool rhs_cap = (M & MODE_RHS_CAP) != 0;
};

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

// eps and tiny come from the host (std::numeric_limits is host code).
template <typename T>
__device__ Column<T> load_column(const KernelArgs& a, int64_t col, T eps, T tiny) {
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
  return c;
}

template <typename T>
struct Center {
  T vl, ti, re;     // stage state (heat-only: vl, ti from the profiles)
  T temp, kappa;    // T and kappa
  T rcs;            // rho_c_s (stage coefficients)
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

// The prognostic fields of a column batch; a branch's absent fields are null.
template <typename T>
struct Fields {
  T* vl;
  T* ti;
  T* re;
};

// The prescribed profiles of one column at one table row, or null: level k
// of profile j at p[j][k * level[j]] (level 1 without MODE_COLUMNS).
template <typename T, int M>
struct Profiles {
  const T* p[kNumProfiles];
  int64_t level[kNumProfiles];
  __device__ T at(int j, int64_t k) const { return p[j][Modes<M>::columns ? k * level[j] : k]; }
};

// The grid of one column: its spacing, and level k's center (zc_stride 1
// without MODE_COLUMNS).
template <typename T, int M>
struct Grid {
  const T* zc;
  int64_t zc_stride;
  T dz;
  __device__ T z(int64_t k) const { return zc[Modes<M>::columns ? k * zc_stride : k]; }
};

template <typename T, int M>
__device__ Grid<T, M> load_grid(const KernelArgs& a, int64_t col) {
  Grid<T, M> g;
  g.zc = static_cast<const T*>(a.zc);
  g.zc_stride = 1;
  g.dz = T(a.dz);
  if (Modes<M>::columns) {
    g.zc += col * a.zc_col_stride;
    g.zc_stride = a.zc_level_stride;
    if (a.dz_col) g.dz = static_cast<const T*>(a.dz_col)[col * a.dz_col_stride];
  }
  return g;
}

// The kind of BC slot j at column col: the slot's own, or for a BatchedBC
// slot the column's.
template <int M>
__device__ __forceinline__ int64_t column_kind(const KernelArgs& a, int j, int64_t col) {
  return Modes<M>::columns && a.bc_kind[j] == BC_BATCHED
             ? int64_t(static_cast<const int32_t*>(a.bc_kind_col[j])[col * a.bc_kind_col_stride[j]])
             : a.bc_kind[j];
}

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

// d max(x, bound)/dx (above) or d min(x, bound)/dx as jax.grad gives it: 1
// where x passes, 0 where the bound does, 1/2 at a tie.
template <typename T> __device__ __forceinline__ T tie_gate(T x, T bound, bool above) {
  bool passes = above ? x > bound : x < bound;
  return passes ? T(1) : (x == bound ? T(0.5) : T(0));
}

// water.py::dpsi_dtheta: d psi / d vartheta_l of pressure_head in closed form.
template <typename T>
__device__ T dpsi_dtheta(const Column<T>& c, T vl, T nu_eff) {
  T theta_r = c.p[P_THETA_R];
  T floor = theta_r + c.eps;
  T S = (d_max(vl, floor) - theta_r) / (nu_eff - theta_r);
  T S_low = d_max(S, c.eps);
  T S_safe = d_min(S_low, T(1) - c.eps);
  T u_inv = d_exp(d_log(S_safe) * c.p[P_NEG_INV_M]);
  T base = (u_inv - T(1)) * c.p[P_ALPHA_POW_NEG_N];
  T psi = -d_exp(d_log(d_max(base, c.tiny)) * c.p[P_INV_N]);
  T gate = tie_gate(vl, floor, true) * tie_gate(S, c.eps, true) *
           tie_gate(S_low, T(1) - c.eps, false) * tie_gate(base, c.tiny, true);
  T C_unsat = (-psi) * u_inv / (c.p[P_N_M] * S_safe * (u_inv - T(1)) * (nu_eff - theta_r));
  T unsat = S < T(1) ? C_unsat * gate : T(0);
  return S <= T(1) ? unsat : T(1) / c.p[P_S_S];
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

// ---- rhs.py: center fields ----

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

// The center fields of one rhs evaluation.  Stage coefficients evaluate the
// closures here; lagged ones read them from `coef` at index i and diagnose
// T through the frozen reciprocal heat capacity.  The water-only branch
// takes T from the profile (`temp_prescribed`) and needs no thermal field;
// the heat-only branch gets vartheta_l and theta_i from the profiles and
// needs no hydraulic field.
template <typename T, int M>
__device__ Center<T> center_fields(const Column<T>& c, const Coefs<T>& coef,
                                   int64_t i, T vl, T ti, T re, T temp_prescribed, T z) {
  Center<T> x;
  x.vl = vl;
  x.ti = ti;
  x.re = re;
  x.kappa = x.rcs = x.K = x.psi = x.h = x.reK = T(0);
  x.src_l = x.src_i = T(0);
  T nu_eff = Modes<M>::no_ice ? c.p[P_NU] : c.p[P_NU] - ti;
  T theta_l = d_min(vl, Modes<M>::no_ice && !Modes<M>::rhs_cap ? c.p[P_NU] : c.p[P_NU] - ti);
  if (Modes<M>::water) {
    x.temp = temp_prescribed;
    x.K = Modes<M>::lagged   ? coef.K[i]
          : Modes<M>::no_ice ? conductivity_no_ice(c, vl, temp_prescribed)
                             : conductivity(c, vl, ti, temp_prescribed);
  } else if (Modes<M>::heat) {
    if (Modes<M>::lagged) {
      T inv_rho_c_s = coef.inv_rho_c_s[i];
      x.temp = Modes<M>::no_ice ? c.T_0 + re * inv_rho_c_s
                                : c.T_0 + (re + ti * c.rho_ice * c.LH_f0) * inv_rho_c_s;
      x.kappa = coef.kappa[i];
    } else if (Modes<M>::no_ice) {
      // rhs.py's heat-only branch caps theta_l at nu - theta_i, no ice or not
      T theta_l_h = d_min(vl, c.p[P_NU] - ti);
      x.rcs = c.p[P_RHO_C_DS] + theta_l_h * c.rho_cp_l;
      x.temp = c.T_0 + re / x.rcs;
      x.kappa = thermal_conductivity_no_ice(c, theta_l_h);
    } else {
      x.rcs = c.p[P_RHO_C_DS] + theta_l * c.rho_cp_l + ti * c.rho_cp_i;
      x.temp = c.T_0 + (re + ti * c.rho_ice * c.LH_f0) / x.rcs;
      x.kappa = thermal_conductivity(c, vl, ti);
    }
    return x;
  } else if (Modes<M>::lagged) {
    T inv_rho_c_s = coef.inv_rho_c_s[i];
    x.temp = Modes<M>::no_ice
                 ? c.T_0 + re * inv_rho_c_s
                 : c.T_0 + (re + ti * c.rho_ice * c.LH_f0) * inv_rho_c_s;
    x.kappa = coef.kappa[i];
    x.K = coef.K[i];
    x.reK = coef.KE[i];
    x.rcs = Modes<M>::rate ? coef.rho_c_s[i] : T(0);
  } else {
    closures<T, M>(c, vl, ti, re, theta_l, &x.temp, &x.kappa, &x.rcs, &x.K);
    T rho_e_int_l = c.rho_cp_l * (x.temp - c.T_0);
    x.reK = rho_e_int_l * x.K;
  }
  x.psi = pressure_head(c, vl, nu_eff);
  x.h = x.psi + z;
  if (Modes<M>::rate) {
    phase_change_sources(c, theta_l, ti, x.temp, x.rcs, &x.src_l, &x.src_i);
  }
  return x;
}

// ---- boundary.py: boundary_fluxes at one face ----
// `slot_*` is the slot's kind and `kind_*` the column's (they differ only in
// a BC_BATCHED slot).  A plain Dirichlet slot's value overwrites the face
// state before either flux is computed, so it enters the other component's
// flux too; a BatchedBC column's Dirichlet value enters only its own flux
// (boundary.py: set_boundary_values overwrites the face for a Dirichlet
// alone, a BatchedBC candidate inside its own flux).  The boundary fluxes
// are never lagged: free drainage takes K of the stage state (`live_K`) in
// the lagged mode.  Nor do they assume no ice: under MODE_NO_ICE the faces
// read the state's theta_i, as boundary.py does (the center's K and psi
// assume none).  A prescribed component (BC_NONE slot) has no flux, and
// the branch never reads it; a dynamic component's slot is never BC_NONE
// (the host checks).  An energy column of kind FREE_DRAINAGE (a code the
// host refuses) has no flux, as the eager select gives it.
template <typename T, int M>
__device__ void face_fluxes(const Column<T>& c, const Center<T>& x,
                            int64_t slot_e, int64_t kind_e, T val_e,
                            int64_t slot_w, int64_t kind_w, T val_w,
                            bool top, bool live_K, T dzb, T* f_e, T* f_w) {
  const T vl_shared = slot_w == BC_DIRICHLET ? val_w : x.vl;
  const T temp_shared = slot_e == BC_DIRICHLET ? val_e : x.temp;
  *f_e = T(0);
  *f_w = T(0);
  if (!Modes<M>::water) {
    if (kind_e == BC_FLUX) {
      *f_e = val_e;
    } else if (kind_e == BC_DIRICHLET) {
      T kappa_f = thermal_conductivity(c, vl_shared, x.ti);
      T flux = (-kappa_f) * (val_e - x.temp) / dzb;
      *f_e = top ? flux : -flux;
    }
  }
  if (!Modes<M>::heat) {
    if (kind_w == BC_FLUX) {
      *f_w = val_w;
    } else if (kind_w == BC_FREE_DRAINAGE) {
      *f_w = -(live_K || Modes<M>::no_ice ? conductivity(c, x.vl, x.ti, x.temp) : x.K);
    } else {  // Dirichlet
      T K_f = conductivity(c, val_w, x.ti, temp_shared);
      T psi_f = pressure_head(c, val_w, c.p[P_NU] - x.ti);
      const T psi_c = Modes<M>::no_ice ? pressure_head(c, x.vl, c.p[P_NU] - x.ti) : x.psi;
      *f_w = top ? (-K_f) * (psi_f - psi_c + dzb) / dzb
                 : (-K_f) * (psi_c - psi_f + dzb) / dzb;
    }
  }
}

// The BC values of table row `row` for column `col`.
template <typename T>
__device__ void load_bc(const KernelArgs& a, int64_t row, int64_t col, T bc_val[kNumBC]) {
  for (int j = 0; j < kNumBC; ++j) {
    bc_val[j] = a.bc_kind[j] == BC_FREE_DRAINAGE || a.bc_kind[j] == BC_NONE
                    ? T(0)
                    : static_cast<const T*>(a.bc_ptr[j])[row * a.bc_row_stride[j] +
                                                         col * a.bc_col_stride[j]];
  }
}

// Column `col`'s profiles at table row `row`: without MODE_COLUMNS (nz,)
// rows, row r at r * nz.
template <typename T, int M>
__device__ Profiles<T, M> load_profiles(const KernelArgs& a, int64_t row, int64_t col) {
  Profiles<T, M> prof;
  for (int j = 0; j < kNumProfiles; ++j) {
    const T* base = static_cast<const T*>(a.profile[j]);
    prof.p[j] = !base ? nullptr
                      : Modes<M>::columns ? base + row * a.profile_row_stride[j] + col * a.profile_col_stride[j]
                                          : base + row * a.nz;
    prof.level[j] = a.profile_level_stride[j];
  }
  return prof;
}

// ---- rhs.py: one rhs evaluation over a column ----
// The tendency of state `u` at the BC values and profile rows of one table
// row, bottom to top with a sliding window over the levels: for each level
// k, once its center fields x and both its face fluxes are known,
// emit(k, x, d_vl, d_ti, d_re) receives its tendencies.  Level k-1 is
// emitted after level k is read, so `emit` may overwrite level k-1 of `u`.
template <typename T, int M, typename Emit>
__device__ void rhs_sweep(const Column<T>& c, const KernelArgs& a, int64_t col,
                          Fields<T> u, const T bc_val[kNumBC], const Profiles<T, M>& prof,
                          const Grid<T, M>& g, const Coefs<T>& coef, Emit emit) {
  const int64_t nz = a.nz, ncol = a.ncol;
  const T dz = g.dz;
  const T dzb = dz / T(2);
  auto face = [&](bool top, const Center<T>& x, T* f_e, T* f_w) {
    const int je = top ? BC_TOP_ENERGY : BC_BOTTOM_ENERGY;
    const int jw = top ? BC_TOP_HYDROLOGY : BC_BOTTOM_HYDROLOGY;
    face_fluxes<T, M>(c, x, a.bc_kind[je], column_kind<M>(a, je, col), bc_val[je], a.bc_kind[jw],
                      column_kind<M>(a, jw, col), bc_val[jw], top, Modes<M>::lagged, dzb, f_e, f_w);
  };

  auto tendencies = [&](int64_t k, const Center<T>& x, T dF_w, T dF_e) {
    T d_vl = T(0), d_ti = T(0), d_re = T(0);
    if (!Modes<M>::heat) d_vl = -(dF_w / dz);
    if (Modes<M>::rate) {
      d_vl = d_vl + x.src_l;
      d_ti = d_ti + x.src_i;
    }
    if (!Modes<M>::water) d_re = -(dF_e / dz);
    emit(k, x, d_vl, d_ti, d_re);
  };

  Center<T> prev;
  T Fw_prev = T(0), Fe_prev = T(0);
  for (int64_t k = 0; k < nz; ++k) {
    const int64_t i = k * ncol + col;
    T vl = Modes<M>::heat ? prof.at(PROF_VARTHETA_L, k) : u.vl[i];
    T ti = Modes<M>::heat ? prof.at(PROF_THETA_I, k) : u.ti[i];
    T re = Modes<M>::water ? T(0) : u.re[i];
    T temp = Modes<M>::water ? prof.at(PROF_T, k) : T(0);
    Center<T> x = center_fields<T, M>(c, coef, i, vl, ti, re, temp, g.z(k));
    if (k == 0) {
      face(false, x, &Fe_prev, &Fw_prev);
    } else {
      // interior face between centers k-1 and k: -interp(coef) * grad
      T Fw = T(0), Fe = T(0);
      T grad_h = (x.h - prev.h) / dz;
      if (!Modes<M>::heat) Fw = (-(T(0.5) * (prev.K + x.K))) * grad_h;
      if (Modes<M>::coupled) {
        Fe = (-(T(0.5) * (prev.kappa + x.kappa))) * ((x.temp - prev.temp) / dz) +
             (-(T(0.5) * (prev.reK + x.reK))) * grad_h;
      } else if (Modes<M>::heat) {
        Fe = (-(T(0.5) * (prev.kappa + x.kappa))) * ((x.temp - prev.temp) / dz);
      }
      tendencies(k - 1, prev, Fw - Fw_prev, Fe - Fe_prev);
      Fw_prev = Fw;
      Fe_prev = Fe;
    }
    prev = x;
  }
  T Fe_top, Fw_top;
  face(true, prev, &Fe_top, &Fw_top);
  tendencies(nz - 1, prev, Fw_top - Fw_prev, Fe_top - Fe_prev);
}

// ---- freeze_thaw.py: the equilibrium projection (kernel B3, after a step) ----

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

// lagged.py::compute_coeffs over one column, from the step's start state
// (kernel B2, in the explicit and the implicit kernels).
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

// lagged.py::compute_coeffs of the branch over one column at the step's
// start (the profiles of its first table row): the coupled coefficients of
// coefficients(); K alone on the water-only branch (T from the profile);
// kappa and 1/rho_c_s on the heat-only branch (vartheta_l, theta_i from the
// profiles).  Used by rk_kernel.cu and, on the water-only LandModel, by
// land_column.cuh.
template <typename T, int M>
__device__ void branch_coefficients(const Column<T>& c, const KernelArgs& a, int64_t col, const Fields<T>& Y,
                                    const Profiles<T, M>& prof, const Coefs<T>& coef) {
  if (Modes<M>::coupled) {
    coefficients<T, M>(c, a, col, Y.vl, Y.ti, Y.re, coef);
    return;
  }
  for (int64_t k = 0; k < a.nz; ++k) {
    const int64_t i = k * a.ncol + col;
    if (Modes<M>::water) {
      const T vl = Y.vl[i], ti = Y.ti[i], temp = prof.at(PROF_T, k);
      coef.K[i] = Modes<M>::no_ice ? conductivity_no_ice(c, vl, temp) : conductivity(c, vl, ti, temp);
    } else {
      const T vl = prof.at(PROF_VARTHETA_L, k), ti = prof.at(PROF_THETA_I, k);
      const T theta_l = d_min(vl, Modes<M>::no_ice ? c.p[P_NU] : c.p[P_NU] - ti);
      T temp, kappa, rho_c_s, K;
      closures<T, M>(c, vl, ti, Y.re[i], theta_l, &temp, &kappa, &rho_c_s, &K);
      coef.kappa[i] = kappa;
      coef.inv_rho_c_s[i] = T(1) / rho_c_s;
    }
  }
}

// ---- timestepping.py: one stage of the explicit steppers' stage table ----

// Entry `s` of the launch's stage table (KernelArgs::stage_*, built on the
// host by ops/cuda/column_kernel.py::stage_table): the registers it reads,
// writes and keeps aside, and its coefficients rounded to T, as the eager
// step rounds its Python numbers.
template <typename T>
struct Stage {
  int64_t kind, in, out, aux;
  T h, c1, c2, c3, c4;
};

template <typename T>
__device__ __forceinline__ Stage<T> load_stage(const KernelArgs& a, int s) {
  const double* k = a.stage_c + 5 * s;
  return {a.stage_kind[s], a.stage_in[s], a.stage_out[s], a.stage_aux[s],
          T(k[0]), T(k[1]), T(k[2]), T(k[3]), T(k[4])};
}

// The value stage `st` writes for one value from its value x in the register
// the stage reads and its tendency d there; `y` points at its value in the
// state (read by STAGE_SPLIT) and `aux` at its value in the stage's
// auxiliary register (read by STAGE_COMB and STAGE_FINAL, written with q2 by
// STAGE_SPLIT).  The arithmetic of timestepping.py's _axpy and _lincomb2.
// Used for the soil fields (table_stage) and for a LandModel's pond
// (land_column.cuh).
template <typename T>
__device__ __forceinline__ T stage_value(const Stage<T>& st, T x, T d, const T* y, T* aux) {
  if (st.kind == STAGE_FINAL) return (*aux + st.c1 * x) + st.h * d;
  const T n = x + st.h * d;
  if (st.kind == STAGE_COMB) return st.c1 * *aux + st.c2 * n;
  if (st.kind == STAGE_SPLIT) {
    const T q2 = st.c1 * *y + st.c2 * n;
    *aux = q2;
    return st.c3 * q2 + st.c4 * n;
  }
  return n;
}

// One stage `st` of the soil fields of one column: the rhs sweep of the
// register it reads at the BC values `bc_val` and profiles `prof`, each
// level written to the register the stage names (reg[0] the state, reg[1]
// and reg[2] the two scratch states), with MODE_FREEZE_EQ's projection on
// the step's `last` stage.  A stage that reads and writes one register is
// safe: rhs_sweep emits level k-1 only after it has read level k, and no
// later face reads level k-1 from memory (the sliding window holds it).
// The fields a branch lacks are left alone.
template <typename T, int M>
__device__ void table_stage(const Column<T>& c, const KernelArgs& a, int64_t col, const Fields<T> reg[3],
                            const Stage<T>& st, bool last, const T bc_val[kNumBC], const Profiles<T, M>& prof,
                            const Grid<T, M>& g, const Coefs<T>& coef) {
  const int64_t ncol = a.ncol;
  constexpr bool has_water = !Modes<M>::heat, has_heat = !Modes<M>::water;
  const Fields<T> u = reg[st.in], out = reg[st.out], aux = reg[st.aux];
  const Fields<T> y = reg[0];

  auto write = [&](int64_t k, const Center<T>& x, T d_vl, T d_ti, T d_re) {
    const int64_t i = k * ncol + col;
    T n_vl = T(0), n_ti = T(0), n_re = T(0);
    if (has_water) {
      n_vl = stage_value(st, x.vl, d_vl, &y.vl[i], &aux.vl[i]);
      n_ti = stage_value(st, x.ti, d_ti, &y.ti[i], &aux.ti[i]);
    }
    if (has_heat) n_re = stage_value(st, x.re, d_re, &y.re[i], &aux.re[i]);
    if (Modes<M>::eq && last) phase_projection(c, &n_vl, &n_ti, n_re);
    if (has_water) {
      out.vl[i] = n_vl;
      out.ti[i] = n_ti;
    }
    if (has_heat) out.re[i] = n_re;
  };
  rhs_sweep<T, M>(c, a, col, u, bc_val, prof, g, coef, write);
}

}  // namespace
