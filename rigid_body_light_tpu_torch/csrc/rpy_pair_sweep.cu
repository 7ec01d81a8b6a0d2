// RPY + Swan–Brady wall pair sweeps for Hopper (sm_90a), float32.
//
// Two kernels replace the two Pallas TPU kernels on the fluctuating-BD main
// path (rigid_body_light_tpu/ops/rpy_pallas.py):
//
//   K1 pair_sweep_sym      replaces _kernel_sym (rpy_pallas.py:312): every
//                          unordered pair i<j once, applied forward
//                          (M_ij·F_j into row i) and transposed
//                          (M_ijᵀ·F_i into column j).  Single RHS.
//   K2 pair_sweep_ordered  replaces _kernel (rpy_pallas.py:175): an ordered
//                          rectangular slab, rows × all columns, with global
//                          row/column offsets masking self pairs.  1 or 2 RHS
//                          sharing the pair fields.
//
// Both compute pair terms only: U_i = Σ_{j≠i} M_ij·F_j with positions in
// units of the blob radius.  The caller applies the self term, the
// 1/(8πηa) scale and the B·M·B damping (rigid_body_light_tpu_torch/ops/
// rpy_cuda.py), exactly as rpy_pallas.py:821-853 does.
//
// What bounds them on the card: arithmetic.  Each pair costs ~25 flops of
// free-space fields, ~35 more for the five wall fields, two rsqrt and one
// IEEE division, then ~30 flops per RHS and direction to apply them; the
// operands are 24-48 bytes per blob, so the sweep is O(N²) compute over
// O(N) data that lives in shared memory and registers.  The design keeps
// every pair field in registers, reads column blobs from shared memory
// (broadcast or conflict-free), and writes O(N) partial sums.
//
// The hazard the TPU kernel did not have: _kernel_sym adds into output
// columns across grid programs, which is race-free only because TPU grid
// programs run in sequence.  CUDA blocks run in parallel, so K1 writes
// per-row-tile column partials and per-column-chunk row partials (each
// element written by exactly one block) and a second pass sums them in a
// fixed order.  No atomics: runs are bitwise repeatable.
//
// Numerics: IEEE division and sqrt (no --use_fast_math, no __fdividef —
// approximate reciprocals floor GMRES convergence, rpy_pallas.py:22-26).
// 1/r and 1/R use rsqrtf (≤ 2 ulp), as the Pallas kernel uses lax.rsqrt.
// The guards of the Pallas kernel are kept: r² and R² floored at 1e-24,
// the image height sum floored at 1e-12 in the h/(z_i+z_j) division, and
// masked pairs contribute an exact 0 through a select, never a multiply
// by a mask (the unselected branch may hold inf/NaN).
//
// Plain C interface for ctypes; every launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr float kR2Floor = 1e-24f;
constexpr float kSelfCoef = 4.0f / 3.0f;

// K1 tiling: a block owns 128 rows (one per thread, 4 warps) and a chunk of
// 512 columns, swept in 32-column sub-tiles.
constexpr int kSymRows = 128;
constexpr int kSymChunk = 512;
constexpr int kSymSub = 32;
constexpr int kSymWarps = kSymRows / 32;

// K2 tiling: a block owns 32 rows (one per lane); its 8 warps split each
// 256-column shared tile 8 ways and are summed in a fixed order at the end.
constexpr int kOrdRows = 32;
constexpr int kOrdSplit = 8;
constexpr int kOrdTile = kOrdSplit * 32;

struct Fields {
  float alpha, beta;               // free-space M = α I + β d dᵀ
  float ex, ey, ez;                // wall image direction e
  float f1, f2, f3, f4, f5;        // C = f1 I + f2 e eᵀ + f3 e ẑᵀ + f4 ẑ eᵀ + f5 ẑ ẑᵀ
};

// Pair fields at displacement d = r_i − r_j (units of a); zR, zC the row and
// column heights.  Mirrors _mono_coeffs and _wall_coeffs of rpy_pallas.py.
template <bool WALL>
__device__ __forceinline__ Fields pair_fields(float dx, float dy, float dz,
                                              float zR, float zC,
                                              float h_floor) {
  Fields p;
  const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, kR2Floor);
  const float invr = rsqrtf(r2);
  const float invr2 = invr * invr;
  const float r = r2 * invr;
  const bool far = r >= 2.0f;
  p.alpha = far ? (1.0f + (2.0f / 3.0f) * invr2) * invr
                : kSelfCoef * (1.0f - 0.28125f * r);
  p.beta = far ? (1.0f - 2.0f * invr2) * invr2 * invr
               : (kSelfCoef * 0.09375f) * invr;
  if (WALL) {
    const float zRw = h_floor > 0.0f ? fmaxf(zR, h_floor) : zR;
    const float zCw = h_floor > 0.0f ? fmaxf(zC, h_floor) : zC;
    const float dzi = zRw + zCw;
    const float R2 = fmaxf(dx * dx + dy * dy + dzi * dzi, kR2Floor);
    const float invR = rsqrtf(R2);
    p.ex = dx * invR;
    p.ey = dy * invR;
    p.ez = dzi * invR;
    const float ez2 = p.ez * p.ez;
    const float invR3 = invR * invR * invR;
    const float invR5 = invR3 * invR * invR;
    const float h_hat = zCw / fmaxf(dzi, 1e-12f);
    const float hh = h_hat * (1.0f - h_hat);
    p.f1 = -(3.0f * (1.0f + 2.0f * hh * ez2) * invR
             + 2.0f * (1.0f - 3.0f * ez2) * invR3
             - 2.0f * (1.0f - 5.0f * ez2) * invR5) * (1.0f / 3.0f);
    p.f2 = -(3.0f * (1.0f - 6.0f * hh * ez2) * invR
             - 6.0f * (1.0f - 5.0f * ez2) * invR3
             + 10.0f * (1.0f - 7.0f * ez2) * invR5) * (1.0f / 3.0f);
    p.f3 = p.ez * (3.0f * h_hat * (1.0f - 6.0f * (1.0f - h_hat) * ez2) * invR
                   - 6.0f * (1.0f - 5.0f * ez2) * invR3
                   + 10.0f * (2.0f - 7.0f * ez2) * invR5) * (2.0f / 3.0f);
    p.f4 = p.ez * (3.0f * h_hat * invR - 10.0f * invR5) * (2.0f / 3.0f);
    p.f5 = -(3.0f * h_hat * h_hat * ez2 * invR
             + 3.0f * ez2 * invR3
             + (2.0f - 15.0f * ez2) * invR5) * (4.0f / 3.0f);
  }
  return p;
}

// M_ij·F (forward).  With TRANSPOSE, M_ijᵀ·F = M_ji·F: the free block is
// symmetric and the wall block swaps the roles of f3 and f4
// (rpy_pallas.py:421-424 vs :443-446).
template <bool WALL, bool TRANSPOSE>
__device__ __forceinline__ void apply(const Fields& p, float dx, float dy,
                                      float dz, float fx, float fy, float fz,
                                      float& ux, float& uy, float& uz) {
  const float bdF = p.beta * (dx * fx + dy * fy + dz * fz);
  ux = p.alpha * fx + bdF * dx;
  uy = p.alpha * fy + bdF * dy;
  uz = p.alpha * fz + bdF * dz;
  if (WALL) {
    const float eF = p.ex * fx + p.ey * fy + p.ez * fz;
    const float f2eF = p.f2 * eF;
    const float fa = TRANSPOSE ? p.f4 : p.f3;   // multiplies fz·e
    const float fb = TRANSPOSE ? p.f3 : p.f4;   // multiplies eF·ẑ
    ux += p.f1 * fx + f2eF * p.ex + fa * fz * p.ex;
    uy += p.f1 * fy + f2eF * p.ey + fa * fz * p.ey;
    uz += p.f1 * fz + f2eF * p.ez + fa * fz * p.ez + fb * eF + p.f5 * fz;
  }
}

// K1.  Grid (row tiles, column chunks).  Thread t owns row i = 128·I + t and
// keeps its forward sum in registers.  For a 32-column sub-tile, lane l of
// each warp visits column (l + s) mod 32 at step s, so the 32 lanes of a
// warp always touch 32 distinct columns: each warp adds its transposed
// terms into its own shared column accumulator without conflicts
// (__syncwarp orders the steps), and the 4 warps' accumulators are summed
// in a fixed order into col_part[I].  Row sums go to row_part[C].
template <bool WALL>
__global__ void __launch_bounds__(kSymRows)
pair_sweep_sym_kernel(const float* __restrict__ pos,     // (n, 3)
                      const float* __restrict__ force,   // (n, 3)
                      int n, float h_floor,
                      float* __restrict__ row_part,      // (n_chunks, 3, n)
                      float* __restrict__ col_part) {    // (n_row_tiles, 3, n)
  __shared__ float s_pos[3][kSymSub];
  __shared__ float s_f[3][kSymSub];
  __shared__ float s_acc[kSymWarps][3][kSymSub];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = blockIdx.x * kSymRows;
  const int i = row0 + t;
  const bool row_ok = i < n;
  const int col_begin = blockIdx.y * kSymChunk;
  const int col_end = min(col_begin + kSymChunk, n);

  float xR = 0.0f, yR = 0.0f, zR = 1.0f, fxR = 0.0f, fyR = 0.0f, fzR = 0.0f;
  if (row_ok) {
    xR = pos[3 * i]; yR = pos[3 * i + 1]; zR = pos[3 * i + 2];
    fxR = force[3 * i]; fyR = force[3 * i + 1]; fzR = force[3 * i + 2];
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  float* colp = col_part + (size_t)blockIdx.x * 3 * n;

  for (int c0 = col_begin; c0 < col_end; c0 += kSymSub) {
    const int c_last = min(c0 + kSymSub, n) - 1;
    if (c_last <= row0) {
      // no pair j > i in this sub-tile (block-uniform): its column
      // partials are zero
      for (int idx = t; idx < 3 * kSymSub; idx += kSymRows) {
        const int j = c0 + idx % kSymSub;
        if (j < n) colp[(size_t)(idx / kSymSub) * n + j] = 0.0f;
      }
      continue;
    }
    __syncthreads();  // the previous sub-tile's shared reads are done
    if (t < kSymSub) {
      const int j = c0 + t;
      const bool ok = j < n;
      s_pos[0][t] = ok ? pos[3 * j] : 0.0f;
      s_pos[1][t] = ok ? pos[3 * j + 1] : 0.0f;
      s_pos[2][t] = ok ? pos[3 * j + 2] : 1.0f;
      s_f[0][t] = ok ? force[3 * j] : 0.0f;
      s_f[1][t] = ok ? force[3 * j + 1] : 0.0f;
      s_f[2][t] = ok ? force[3 * j + 2] : 0.0f;
    }
    for (int idx = t; idx < kSymWarps * 3 * kSymSub; idx += kSymRows)
      (&s_acc[0][0][0])[idx] = 0.0f;
    __syncthreads();

    for (int s = 0; s < kSymSub; ++s) {
      const int c = (lane + s) & (kSymSub - 1);
      const int j = c0 + c;
      const bool valid = row_ok && j < n && j > i;
      const float zC = s_pos[2][c];
      const float dx = xR - s_pos[0][c];
      const float dy = yR - s_pos[1][c];
      const float dz = zR - zC;
      const Fields p = pair_fields<WALL>(dx, dy, dz, zR, zC, h_floor);
      float ux, uy, uz, tx, ty, tz;
      apply<WALL, false>(p, dx, dy, dz, s_f[0][c], s_f[1][c], s_f[2][c],
                         ux, uy, uz);
      apply<WALL, true>(p, dx, dy, dz, fxR, fyR, fzR, tx, ty, tz);
      ax += valid ? ux : 0.0f;
      ay += valid ? uy : 0.0f;
      az += valid ? uz : 0.0f;
      s_acc[warp][0][c] += valid ? tx : 0.0f;
      s_acc[warp][1][c] += valid ? ty : 0.0f;
      s_acc[warp][2][c] += valid ? tz : 0.0f;
      __syncwarp();
    }
    __syncthreads();
    for (int idx = t; idx < 3 * kSymSub; idx += kSymRows) {
      const int comp = idx / kSymSub;
      const int c = idx % kSymSub;
      const int j = c0 + c;
      if (j < n) {
        float v = 0.0f;
        for (int w = 0; w < kSymWarps; ++w) v += s_acc[w][comp][c];
        colp[(size_t)comp * n + j] = v;
      }
    }
  }
  if (row_ok) {
    float* rowp = row_part + (size_t)blockIdx.y * 3 * n;
    rowp[i] = ax;
    rowp[(size_t)n + i] = ay;
    rowp[(size_t)2 * n + i] = az;
  }
}

// K1 second pass: out[i] = Σ_C row_part[C][:, i] + Σ_I col_part[I][:, i],
// in that fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ row_part,
                                    int n_chunks,
                                    const float* __restrict__ col_part,
                                    int n_row_tiles, int n,
                                    float* __restrict__ out) {   // (n, 3)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * n) return;
  const int comp = idx / n;
  const int i = idx - comp * n;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    s += row_part[((size_t)c * 3 + comp) * n + i];
  for (int r = 0; r < n_row_tiles; ++r)
    s += col_part[((size_t)r * 3 + comp) * n + i];
  out[(size_t)i * 3 + comp] = s;
}

// K2.  Block (32, 8): lane = row within the block's 32 rows, threadIdx.y =
// which 32 columns of each 256-column shared tile this warp sweeps (every
// lane of a warp reads the same column: a shared-memory broadcast).  A pair
// is live iff its global ids differ and the column is in range.
template <bool WALL, int NRHS>
__global__ void __launch_bounds__(kOrdRows * kOrdSplit)
pair_sweep_ordered_kernel(const float* __restrict__ rows_pos,   // (n_rows, 3)
                          int n_rows, int row_offset,
                          const float* __restrict__ cols_pos,   // (n_cols, 3)
                          const float* __restrict__ cols_force, // (NRHS, n_cols, 3)
                          int n_cols, int col_offset, float h_floor,
                          float* __restrict__ out) {            // (NRHS, n_rows, 3)
  __shared__ float s_pos[3][kOrdTile];
  __shared__ float s_f[3 * NRHS][kOrdTile];
  __shared__ float s_red[kOrdSplit][3 * NRHS][kOrdRows];

  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int t = w * kOrdRows + lane;
  const int i = blockIdx.x * kOrdRows + lane;
  const bool row_ok = i < n_rows;
  const int gi = row_offset + i;

  float xR = 0.0f, yR = 0.0f, zR = 1.0f;
  if (row_ok) {
    xR = rows_pos[3 * i]; yR = rows_pos[3 * i + 1]; zR = rows_pos[3 * i + 2];
  }
  float acc[3 * NRHS];
#pragma unroll
  for (int q = 0; q < 3 * NRHS; ++q) acc[q] = 0.0f;

  for (int c0 = 0; c0 < n_cols; c0 += kOrdTile) {
    __syncthreads();
    {
      const int j = c0 + t;
      const bool ok = j < n_cols;
      s_pos[0][t] = ok ? cols_pos[3 * j] : 0.0f;
      s_pos[1][t] = ok ? cols_pos[3 * j + 1] : 0.0f;
      s_pos[2][t] = ok ? cols_pos[3 * j + 2] : 1.0f;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float* fk = cols_force + (size_t)k * 3 * n_cols;
        s_f[3 * k][t] = ok ? fk[3 * j] : 0.0f;
        s_f[3 * k + 1][t] = ok ? fk[3 * j + 1] : 0.0f;
        s_f[3 * k + 2][t] = ok ? fk[3 * j + 2] : 0.0f;
      }
    }
    __syncthreads();
    for (int q = 0; q < 32; ++q) {
      const int c = w * 32 + q;
      const int j = c0 + c;
      const bool valid = row_ok && j < n_cols && gi != col_offset + j;
      const float zC = s_pos[2][c];
      const float dx = xR - s_pos[0][c];
      const float dy = yR - s_pos[1][c];
      const float dz = zR - zC;
      const Fields p = pair_fields<WALL>(dx, dy, dz, zR, zC, h_floor);
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        float ux, uy, uz;
        apply<WALL, false>(p, dx, dy, dz, s_f[3 * k][c], s_f[3 * k + 1][c],
                           s_f[3 * k + 2][c], ux, uy, uz);
        acc[3 * k] += valid ? ux : 0.0f;
        acc[3 * k + 1] += valid ? uy : 0.0f;
        acc[3 * k + 2] += valid ? uz : 0.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3 * NRHS; ++q) s_red[w][q][lane] = acc[q];
  __syncthreads();
  if (w == 0 && row_ok) {
#pragma unroll
    for (int q = 0; q < 3 * NRHS; ++q) {
      float v = 0.0f;
      for (int s = 0; s < kOrdSplit; ++s) v += s_red[s][q][lane];
      out[((size_t)(q / 3) * n_rows + i) * 3 + q % 3] = v;
    }
  }
}

template <bool WALL>
void launch_ordered(int nrhs, dim3 grid, dim3 block, cudaStream_t stream,
                    const float* rows_pos, int n_rows, int row_offset,
                    const float* cols_pos, const float* cols_force,
                    int n_cols, int col_offset, float h_floor, float* out) {
  if (nrhs == 1)
    pair_sweep_ordered_kernel<WALL, 1><<<grid, block, 0, stream>>>(
        rows_pos, n_rows, row_offset, cols_pos, cols_force, n_cols,
        col_offset, h_floor, out);
  else
    pair_sweep_ordered_kernel<WALL, 2><<<grid, block, 0, stream>>>(
        rows_pos, n_rows, row_offset, cols_pos, cols_force, n_cols,
        col_offset, h_floor, out);
}

}  // namespace

extern "C" {

// Tile sizes the wrapper needs to size K1's partial buffers.
int rpy_sym_rows_per_tile() { return kSymRows; }
int rpy_sym_cols_per_chunk() { return kSymChunk; }

// K1: out (n, 3) = Σ_{j≠i} M_ij F_j over unordered pairs.  row_part holds
// ⌈n/512⌉·3·n floats, col_part ⌈n/128⌉·3·n floats (scratch, fully
// overwritten).
int rpy_pair_sweep_sym(const float* pos, const float* force, int n, int wall,
                       float h_floor, float* row_part, float* col_part,
                       float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return 0;
  const int n_row_tiles = (n + kSymRows - 1) / kSymRows;
  const int n_chunks = (n + kSymChunk - 1) / kSymChunk;
  const dim3 grid(n_row_tiles, n_chunks);
  if (wall)
    pair_sweep_sym_kernel<true><<<grid, kSymRows, 0, stream>>>(
        pos, force, n, h_floor, row_part, col_part);
  else
    pair_sweep_sym_kernel<false><<<grid, kSymRows, 0, stream>>>(
        pos, force, n, h_floor, row_part, col_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (3 * n + threads - 1) / threads;
  sum_partials_kernel<<<blocks, threads, 0, stream>>>(
      row_part, n_chunks, col_part, n_row_tiles, n, out);
  return static_cast<int>(cudaGetLastError());
}

// K2: out (nrhs, n_rows, 3) = Σ_j M_ij F_j over all columns j whose global
// id (col_offset + j) differs from the row's (row_offset + i).
int rpy_pair_sweep_ordered(const float* rows_pos, int n_rows, int row_offset,
                           const float* cols_pos, const float* cols_force,
                           int n_cols, int col_offset, int nrhs, int wall,
                           float h_floor, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const dim3 grid((n_rows + kOrdRows - 1) / kOrdRows);
  const dim3 block(kOrdRows, kOrdSplit);
  if (wall)
    launch_ordered<true>(nrhs, grid, block, stream, rows_pos, n_rows,
                         row_offset, cols_pos, cols_force, n_cols, col_offset,
                         h_floor, out);
  else
    launch_ordered<false>(nrhs, grid, block, stream, rows_pos, n_rows,
                          row_offset, cols_pos, cols_force, n_cols,
                          col_offset, h_floor, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
