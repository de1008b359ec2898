// The column-tile kernel: the coupled plain soil with stage coefficients and
// per-column BC kinds and geometry (MODE_COLUMNS; kernel modes B1-batched and
// B8), with ice or under assume_no_ice, stepped by ForwardEuler, SSPRK22,
// SSPRK33 or SSPRK104 from the launch's stage table.
//
// Replaces landhydrology_tpu/ops/pallas/column_kernel.py::_run (:488,
// launched by pl.pallas_call at :624-649) in those modes: the coupled branch
// (:417-484, models/soil/rhs.py; rhs.py:90-140 under assume_no_ice) with
// per-column kinds (:265, :288, boundary.py:371-408) and depths (:238-249,
// :583-599), `n_steps` steps per launch, in place.  Before it, the same modes
// ran one thread per column in column_kernel.cu (SSPRK33 with ice) and
// rk_columns_kernel.cu (the rest), whose stage registers lived in device
// memory.
//
// Bound: floating-point operations, in f64 and in f32.  A cell evaluates about
// fourteen exp/log/sqrt chains and a dozen divisions per stage (the closures
// of column_common.cuh), and the state is read and written once per launch,
// so the card's operation rate is the bound chip_smoke.py computes.  What the
// design does about it:
//   - The tile stays on chip for the whole launch.  A block owns `tc`
//     columns; it loads their state once into shared memory, keeps the
//     state and the stage table's two scratch registers there for all
//     n_steps steps, and writes the state back once.  Device memory sees the
//     state once in and once out: no scratch buffer (scratch_fields is 0).
//   - Levels spread over threads: threadIdx.x is the column in the tile,
//     threadIdx.y one of `lanes` level lanes, and a thread takes levels
//     k = y, y + lanes, ... of its column, so the closures of a column's
//     levels run in parallel.  Each stage is two phases split by
//     __syncthreads().  Phase A: every cell writes the previous stage's value
//     from the face fluxes (below), then computes its center fields for this
//     stage and publishes h, K, kappa, T and rho_e_int_l K; the cells of
//     levels 0 and nz-1 also form the boundary faces (only their threads read
//     BC values and kinds).  Phase B: every cell k > 0 forms the interior
//     face between levels k-1 and k from the published fields, in
//     rhs_sweep's operand order, once per face.  The last stage's values are
//     written after the loop.
//   - The per-column constants (Column<T>, 25 parameters) sit in shared
//     memory, one struct per column at a stride of an odd number of 8-byte
//     words, so the columns of a warp read distinct banks; a thread keeps
//     none of them in registers.
//   - The host (ops/cuda/column_kernel.py::tile_plan) picks the columns per
//     tile and the lanes from nz, the float type and the stepper's
//     registers, so that several 256-thread blocks share an SM; the launch
//     bounds hold f64 at 128 registers (two blocks) and f32 at 85 (three).
// Tensor cores, TMA and wgmma have no work here: there is no matrix product,
// and device memory is touched once per launch.
//
// Shared memory of a block (tile_smem_bytes, mirrored by the host): tc
// Column<T> structs, then the cell planes, nz x tc values each with the
// column fastest: 3 n_regs register values (register r, field f at plane
// 3 r + f), the five published fields and the cell's center z; then two
// face planes of (nz + 1) x tc values, the water and energy fluxes of face
// k (between levels k-1 and k; face 0 the bottom, nz the top).

#pragma once

#include "column_common.cuh"

// Mirrored by TILE_* in ops/cuda/column_kernel.py.
constexpr int kTileMaxThreads = 256;
constexpr int kTileMaxSmem = 232448;  // the most dynamic shared memory of a block on Hopper

// The launch bounds' blocks per SM: f64 at 128 registers a thread, f32 at 85.
template <typename T>
struct TileMinBlocks {
  static constexpr int value = sizeof(T) == 8 ? 2 : 3;
};

namespace {

// The cell planes after the registers: the published center fields, then z.
enum TilePlane { TP_H, TP_K, TP_KAPPA, TP_TEMP, TP_REK, TP_Z, kTilePlanes };

// sizeof(Column<T>) rounded up to an odd number of 8-byte words.
template <typename T>
__host__ __device__ constexpr int tile_column_stride() {
  return 8 * (((sizeof(Column<T>) + 7) / 8) | 1);
}

template <typename T>
int64_t tile_smem_bytes(int64_t nz, int64_t tc, int64_t n_regs) {
  return tc * tile_column_stride<T>() + ((3 * n_regs + kTilePlanes) * nz + 2 * (nz + 1)) * tc * int64_t(sizeof(T));
}

// The registers the launch's stage table touches: 1 (ForwardEuler), 2
// (SSPRK22) or 3.
inline int64_t tile_registers(const KernelArgs& a) {
  int64_t r = 0;
  for (int s = 0; s < a.n_stages; ++s) {
    r = a.stage_in[s] > r ? a.stage_in[s] : r;
    r = a.stage_out[s] > r ? a.stage_out[s] : r;
    if (a.stage_kind[s] != STAGE_AXPY) r = a.stage_aux[s] > r ? a.stage_aux[s] : r;
  }
  return r + 1;
}

template <typename T, int M>
__global__ void __launch_bounds__(kTileMaxThreads, TileMinBlocks<T>::value)
    tile_column_kernel(const KernelArgs a, T eps, T tiny, int n_regs) {
  static_assert(Modes<M>::coupled && Modes<M>::columns && !Modes<M>::lagged && !Modes<M>::rate &&
                    !Modes<M>::eq && !Modes<M>::most && !Modes<M>::land,
                "the tile kernel runs the coupled plain soil with stage coefficients and MODE_COLUMNS");
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tc = blockDim.x, lanes = blockDim.y;
  const int cx = threadIdx.x, ly = threadIdx.y;
  const int nz = static_cast<int>(a.nz);
  const int64_t ncol = a.ncol;
  const int64_t col = int64_t(blockIdx.x) * tc + cx;
  const bool active = col < ncol;  // the ragged last tile masks its missing columns

  Column<T>& c = *reinterpret_cast<Column<T>*>(tile_smem + cx * tile_column_stride<T>());
  T* const cells = reinterpret_cast<T*>(tile_smem + tc * tile_column_stride<T>());
  const int plane = nz * tc;
  // register r's field f (vartheta_l, theta_i, rho_e_int) at reg(r) + f * plane
  auto reg = [&](int64_t r) { return cells + 3 * r * plane; };
  T* const pub = cells + 3 * n_regs * plane;
  T* const h = pub + TP_H * plane;
  T* const K = pub + TP_K * plane;
  T* const kappa = pub + TP_KAPPA * plane;
  T* const temp = pub + TP_TEMP * plane;
  T* const reK = pub + TP_REK * plane;
  T* const z = pub + TP_Z * plane;
  // face k of the column at k * tc + cx, as level k's cell
  T* const Fw = pub + kTilePlanes * plane;
  T* const Fe = Fw + (nz + 1) * tc;
  T* const state[3] = {static_cast<T*>(a.vartheta_l), static_cast<T*>(a.theta_i), static_cast<T*>(a.rho_e_int)};

  T dz = T(1);
  if (active) {
    if (ly == 0) c = load_column<T>(a, col, eps, tiny);
    const Grid<T, M> g = load_grid<T, M>(a, col);
    dz = g.dz;
    for (int k = ly; k < nz; k += lanes) {
      const int j = k * tc + cx;
      for (int f = 0; f < 3; ++f) cells[f * plane + j] = state[f][k * ncol + col];
      z[j] = g.z(k);
    }
  }
  __syncthreads();

  // The value stage `st` writes at cell j: its tendencies from the faces below
  // and above, then stage_value of each field (the arithmetic of rhs_sweep's
  // tendencies and table_stage's write).
  auto write = [&](const Stage<T>& st, int j) {
    const T* u = reg(st.in);
    T* out = reg(st.out);
    T* aux = reg(st.kind == STAGE_AXPY ? 0 : st.aux);
    const T d_vl = -((Fw[j + tc] - Fw[j]) / dz);
    const T d_re = -((Fe[j + tc] - Fe[j]) / dz);
    const T n_vl = stage_value(st, u[j], d_vl, &cells[j], &aux[j]);
    const T n_ti = stage_value(st, u[plane + j], T(0), &cells[plane + j], &aux[plane + j]);
    const T n_re = stage_value(st, u[2 * plane + j], d_re, &cells[2 * plane + j], &aux[2 * plane + j]);
    out[j] = n_vl;
    out[plane + j] = n_ti;
    out[2 * plane + j] = n_re;
  };

  const Coefs<T> coef{};  // stage coefficients: center_fields reads none
  const bool bc_lane = ly == 0 || ly == (nz - 1) % lanes;
  Stage<T> prev{};
  bool pending = false;  // a stage whose values are still to be written
  for (int64_t step = 0; step < a.n_steps; ++step) {
    for (int s = 0; s < a.n_stages; ++s) {
      const Stage<T> st = load_stage<T>(a, s);
      const T* const u = reg(st.in);

      // phase A: the previous stage's values, this stage's center fields and the boundary faces
      if (active) {
        T bc_val[kNumBC];
        if (bc_lane) load_bc(a, a.rows_per_step * step + s, col, bc_val);
        auto face = [&](bool top, const Center<T>& x, int j) {
          const int je = top ? BC_TOP_ENERGY : BC_BOTTOM_ENERGY;
          const int jw = top ? BC_TOP_HYDROLOGY : BC_BOTTOM_HYDROLOGY;
          face_fluxes<T, M>(c, x, a.bc_kind[je], column_kind<M>(a, je, col), bc_val[je], a.bc_kind[jw],
                            column_kind<M>(a, jw, col), bc_val[jw], top, Modes<M>::lagged, dz / T(2), &Fe[j],
                            &Fw[j]);
        };
        for (int k = ly; k < nz; k += lanes) {
          const int j = k * tc + cx;
          if (pending) write(prev, j);
          const Center<T> x = center_fields<T, M>(c, coef, 0, u[j], u[plane + j], u[2 * plane + j], T(0), z[j]);
          h[j] = x.h;
          K[j] = x.K;
          kappa[j] = x.kappa;
          temp[j] = x.temp;
          reK[j] = x.reK;
          if (k == 0) face(false, x, cx);
          if (k == nz - 1) face(true, x, nz * tc + cx);
        }
      }
      __syncthreads();

      // phase B: each interior face, from levels (k-1, k): rhs_sweep's -interp(coef) * grad
      if (active) {
        for (int k = ly > 0 ? ly : ly + lanes; k < nz; k += lanes) {
          const int j = k * tc + cx, i = j - tc;
          const T grad_h = (h[j] - h[i]) / dz;
          Fw[j] = (-(T(0.5) * (K[i] + K[j]))) * grad_h;
          Fe[j] = (-(T(0.5) * (kappa[i] + kappa[j]))) * ((temp[j] - temp[i]) / dz) +
                  (-(T(0.5) * (reK[i] + reK[j]))) * grad_h;
        }
      }
      __syncthreads();
      prev = st;
      pending = true;
    }
  }

  if (active) {
    for (int k = ly; k < nz; k += lanes) {
      const int j = k * tc + cx;
      if (pending) write(prev, j);
      for (int f = 0; f < 3; ++f) state[f][k * ncol + col] = cells[f * plane + j];
    }
  }
}

// Launch one instance: `tc` columns per block, `lanes` level lanes, and
// `smem_bytes` of dynamic shared memory, which must be tile_smem_bytes of the
// launch (the host's plan computes it); anything else is refused.
template <typename T, int M>
int tile_launch(const KernelArgs* args, int tc, int lanes, int smem_bytes, void* stream) {
  const int64_t n_regs = tile_registers(*args);
  if (tc < 1 || lanes < 1 || tc * lanes > kTileMaxThreads || smem_bytes > kTileMaxSmem ||
      smem_bytes != tile_smem_bytes<T>(args->nz, tc, n_regs) || args->nz < 1 || args->ncol < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tile_column_kernel<T, M>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (args->ncol + tc - 1) / tc;
  kernel<<<static_cast<unsigned>(grid), dim3(tc, lanes), smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      *args, std::numeric_limits<T>::epsilon(), std::numeric_limits<T>::min(), static_cast<int>(n_regs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
