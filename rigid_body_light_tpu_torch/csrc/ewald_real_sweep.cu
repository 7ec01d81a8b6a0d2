// Ewald real-space pair sweep for Hopper (sm_90a), float32.
//
//   K4 ewald_real_sweep  replaces _kernel_ewald_sym
//                        (rigid_body_light_tpu/ops/ewald_pallas.py:81):
//                        U_i = Σ_{j≠i} [A(r)·I + B(r)·r̂r̂]·F_j under 3-D
//                        minimum image, every unordered pair i<j once,
//                        applied forward (into row i) and transposed (into
//                        column j).  1 or 2 RHS sharing the pair fields.
//
// A(r) and B(r) are never evaluated from their closed forms (those cancel
// catastrophically in float32): they come from the host-fitted float64
// three-segment Chebyshev representation, evaluated by two Clenshaw
// recurrences per pair.  The caller adds the self term and the wave-space
// part (rigid_body_light_tpu_torch/ops/ewald_cuda.py).
//
// What bounds it on the card: arithmetic.  Per unordered pair: separation,
// wrap, distance and segment map (36 flop, one IEEE sqrt and one IEEE
// division), the two Clenshaw chains (a subtract and an FMA per step and
// chain: 6·D, 486 at the degree 81 of a 10,272-blob suspension of a =
// 0.0675 blobs in an L = 14 box) and 36 flop per RHS for the two applies;
// the operands are 24-36 bytes per blob.  Each chain is a serial run of D
// dependent FMAs, so one thread keeps only two of them in flight and the
// kernel leans on occupancy (4 warps per block, several blocks per SM) to
// fill the FMA pipes.  Measured on an H100 (PERF.md): 21-22% of the FP32
// peak at 10,272 blobs, where the ~900 working blocks form one uneven
// wave, 32% over four times the blobs.
//
// The coefficients.  The TPU kernel bakes them into the program and picks
// each by two selects per Clenshaw step.  Here the segment is chosen once
// per pair and the table lives in shared memory as float2 (A_j, B_j) at
// [j][segment] (4 slots per j): one 8-byte read per step serves both
// chains; lanes of one segment read one address (a broadcast), and lanes
// of different segments read neighbouring banks, so a warp with mixed
// segments does not serialise.  The table arrives by pointer with every
// launch, with its degree (at most kMaxDeg), so two operators with
// different boxes cannot read each other's coefficients.
//
// Cross-block accumulation: as K1 (rpy_pair_sweep.cu), per-row-tile column
// partials and per-column-chunk row partials, each element written by
// exactly one block, summed in a fixed order by a second pass.  No
// atomics: launches are bitwise repeatable.
//
// Numerics: rintf (halves to even, as jnp.round), IEEE sqrtf and division
// (no -use_fast_math), r² floored at 1e-24, x clipped to [−1, 1] (below the
// first segment edge the fit is held constant).  A masked pair (j ≤ i, a
// pad row or column) has its distance replaced by 1 before the square
// root and adds an exact 0 through a select.
//
// Plain C interface for ctypes; the launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;    // rows per block, one per thread
constexpr int kChunk = 512;   // columns per block
constexpr int kSub = 32;      // columns per shared sub-tile
constexpr int kWarps = kRows / 32;
constexpr int kMaxDeg = 128;  // largest Chebyshev degree the table holds

// Per-launch constants, passed by value (they live in the constant bank).
struct SweepConsts {
  float box[3];
  float inv_box[3];
  float b1, b2;        // segment edges: segment = (r >= b1) + (r >= b2)
  float lo[3];         // left edge of each segment
  float two_inv_w[3];  // 2 / width of each segment
};

template <int NRHS>
__global__ void __launch_bounds__(kRows)
ewald_real_sweep_kernel(const float* __restrict__ pos,     // (n, 3)
                        const float* __restrict__ force,   // (NRHS, n, 3)
                        int n, SweepConsts cst,
                        const float2* __restrict__ coef,   // (deg+1, 4)
                        int deg,
                        float* __restrict__ row_part,  // (chunks, 3·NRHS, n)
                        float* __restrict__ col_part) {  // (tiles, 3·NRHS, n)
  constexpr int NF = 3 * NRHS;
  __shared__ float2 s_coef[(kMaxDeg + 1) * 4];
  __shared__ float s_pos[3][kSub];
  __shared__ float s_f[NF][kSub];
  __shared__ float s_acc[kWarps][NF][kSub];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + t;
  const bool row_ok = i < n;
  const int col_begin = blockIdx.y * kChunk;
  const int col_end = min(col_begin + kChunk, n);
  float* colp = col_part + (size_t)blockIdx.x * NF * n;

  for (int idx = t; idx < (deg + 1) * 4; idx += kRows) s_coef[idx] = coef[idx];

  float xR = 0.0f, yR = 0.0f, zR = 0.0f;
  float fR[NF];
  float acc[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) { fR[q] = 0.0f; acc[q] = 0.0f; }
  if (row_ok) {
    xR = pos[3 * i]; yR = pos[3 * i + 1]; zR = pos[3 * i + 2];
#pragma unroll
    for (int k = 0; k < NRHS; ++k) {
      const float* fk = force + ((size_t)k * n + i) * 3;
      fR[3 * k] = fk[0]; fR[3 * k + 1] = fk[1]; fR[3 * k + 2] = fk[2];
    }
  }

  for (int c0 = col_begin; c0 < col_end; c0 += kSub) {
    const int c_last = min(c0 + kSub, n) - 1;
    if (c_last <= row0) {
      // no pair j > i in this sub-tile (block-uniform): its column
      // partials are zero
      for (int idx = t; idx < NF * kSub; idx += kRows) {
        const int j = c0 + idx % kSub;
        if (j < n) colp[(size_t)(idx / kSub) * n + j] = 0.0f;
      }
      continue;
    }
    __syncthreads();  // the previous sub-tile's shared reads are done
    if (t < kSub) {
      const int j = c0 + t;
      const bool ok = j < n;
      s_pos[0][t] = ok ? pos[3 * j] : 0.0f;
      s_pos[1][t] = ok ? pos[3 * j + 1] : 0.0f;
      s_pos[2][t] = ok ? pos[3 * j + 2] : 0.0f;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float* fk = force + ((size_t)k * n + j) * 3;
        s_f[3 * k][t] = ok ? fk[0] : 0.0f;
        s_f[3 * k + 1][t] = ok ? fk[1] : 0.0f;
        s_f[3 * k + 2][t] = ok ? fk[2] : 0.0f;
      }
    }
    for (int idx = t; idx < kWarps * NF * kSub; idx += kRows)
      (&s_acc[0][0][0])[idx] = 0.0f;
    __syncthreads();  // also orders the coefficient table's first use

    // lane l visits column (l + s) mod 32 at step s: the 32 lanes of a warp
    // always touch 32 distinct columns, so each warp adds its transposed
    // terms into its own column accumulator without conflicts
    for (int s = 0; s < kSub; ++s) {
      const int c = (lane + s) & (kSub - 1);
      const int j = c0 + c;
      const bool valid = row_ok && j < n && j > i;
      float dx = xR - s_pos[0][c];
      float dy = yR - s_pos[1][c];
      float dz = zR - s_pos[2][c];
      dx -= cst.box[0] * rintf(dx * cst.inv_box[0]);
      dy -= cst.box[1] * rintf(dy * cst.inv_box[1]);
      dz -= cst.box[2] * rintf(dz * cst.inv_box[2]);
      float r2 = fmaxf(dx * dx + dy * dy + dz * dz, 1e-24f);
      r2 = valid ? r2 : 1.0f;
      const float r = sqrtf(r2);
      const float inv_r2 = 1.0f / r2;
      const bool in1 = r >= cst.b1, in2 = r >= cst.b2;
      const int seg = (int)in1 + (int)in2;
      const float lo = in2 ? cst.lo[2] : (in1 ? cst.lo[1] : cst.lo[0]);
      const float two_inv_w = in2 ? cst.two_inv_w[2]
                                  : (in1 ? cst.two_inv_w[1] : cst.two_inv_w[0]);
      float x = (r - lo) * two_inv_w - 1.0f;
      x = fminf(fmaxf(x, -1.0f), 1.0f);
      const float two_x = 2.0f * x;
      // Clenshaw, both chains: b_j = c_j + 2x·b_{j+1} − b_{j+2}
      const float2* cs = s_coef + seg;
      float ya1 = 0.0f, ya2 = 0.0f, yb1 = 0.0f, yb2 = 0.0f;
#pragma unroll 4
      for (int q = deg; q >= 1; --q) {
        const float2 cq = cs[4 * q];
        const float ya = fmaf(two_x, ya1, cq.x - ya2);
        const float yb = fmaf(two_x, yb1, cq.y - yb2);
        ya2 = ya1; ya1 = ya;
        yb2 = yb1; yb1 = yb;
      }
      const float2 cz = cs[0];
      float A = fmaf(x, ya1, cz.x - ya2);
      float Bh = fmaf(x, yb1, cz.y - yb2) * inv_r2;  // r̂r̂ = d dᵀ / r²
      A = valid ? A : 0.0f;
      Bh = valid ? Bh : 0.0f;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float fx = s_f[3 * k][c], fy = s_f[3 * k + 1][c],
                    fz = s_f[3 * k + 2][c];
        const float bdF = Bh * (dx * fx + dy * fy + dz * fz);
        acc[3 * k] += A * fx + bdF * dx;
        acc[3 * k + 1] += A * fy + bdF * dy;
        acc[3 * k + 2] += A * fz + bdF * dz;
        const float bdR = Bh * (dx * fR[3 * k] + dy * fR[3 * k + 1]
                                + dz * fR[3 * k + 2]);
        s_acc[warp][3 * k][c] += A * fR[3 * k] + bdR * dx;
        s_acc[warp][3 * k + 1][c] += A * fR[3 * k + 1] + bdR * dy;
        s_acc[warp][3 * k + 2][c] += A * fR[3 * k + 2] + bdR * dz;
      }
      __syncwarp();
    }
    __syncthreads();
    for (int idx = t; idx < NF * kSub; idx += kRows) {
      const int comp = idx / kSub;
      const int c = idx % kSub;
      const int j = c0 + c;
      if (j < n) {
        float v = 0.0f;
        for (int w = 0; w < kWarps; ++w) v += s_acc[w][comp][c];
        colp[(size_t)comp * n + j] = v;
      }
    }
  }
  if (row_ok) {
    float* rowp = row_part + (size_t)blockIdx.y * NF * n;
#pragma unroll
    for (int q = 0; q < NF; ++q) rowp[(size_t)q * n + i] = acc[q];
  }
}

// Second pass: out[k][i][c] = Σ_C row_part[C][3k+c][i] + Σ_I
// col_part[I][3k+c][i], in that fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ row_part,
                                    int n_chunks,
                                    const float* __restrict__ col_part,
                                    int n_row_tiles, int n, int nf,
                                    float* __restrict__ out) {  // (nrhs, n, 3)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nf * n) return;
  const int comp = idx / n;
  const int i = idx - comp * n;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    s += row_part[((size_t)c * nf + comp) * n + i];
  for (int r = 0; r < n_row_tiles; ++r)
    s += col_part[((size_t)r * nf + comp) * n + i];
  out[((size_t)(comp / 3) * n + i) * 3 + comp % 3] = s;
}

}  // namespace

extern "C" {

// Tile sizes the wrapper needs to size the partial buffers, and the
// largest degree the shared table holds.
int ewald_sweep_rows_per_tile() { return kRows; }
int ewald_sweep_cols_per_chunk() { return kChunk; }
int ewald_sweep_max_degree() { return kMaxDeg; }

// K4: out (nrhs, n, 3) = Σ_{j≠i} [A·I + B·r̂r̂]·F_j over unordered pairs.
// consts: 14 host floats (box[3], inv_box[3], b1, b2, lo[3], two_inv_w[3]).
// coef: device (deg+1, 4, 2) floats, [j][segment] = (A_j, B_j), slot 3
// unused.  row_part holds ⌈n/512⌉·3·nrhs·n floats, col_part
// ⌈n/128⌉·3·nrhs·n floats (scratch, fully overwritten).
int ewald_real_sweep(const float* pos, const float* force, int n, int nrhs,
                     const float* consts, const float* coef, int deg,
                     float* row_part, float* col_part, float* out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (deg < 0 || deg > kMaxDeg) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  SweepConsts cst;
  for (int d = 0; d < 3; ++d) {
    cst.box[d] = consts[d];
    cst.inv_box[d] = consts[3 + d];
    cst.lo[d] = consts[8 + d];
    cst.two_inv_w[d] = consts[11 + d];
  }
  cst.b1 = consts[6];
  cst.b2 = consts[7];
  const int n_row_tiles = (n + kRows - 1) / kRows;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const dim3 grid(n_row_tiles, n_chunks);
  const float2* coef2 = reinterpret_cast<const float2*>(coef);
  if (nrhs == 1)
    ewald_real_sweep_kernel<1><<<grid, kRows, 0, stream>>>(
        pos, force, n, cst, coef2, deg, row_part, col_part);
  else
    ewald_real_sweep_kernel<2><<<grid, kRows, 0, stream>>>(
        pos, force, n, cst, coef2, deg, row_part, col_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nf = 3 * nrhs;
  const int threads = 256;
  const int blocks = (nf * n + threads - 1) / threads;
  sum_partials_kernel<<<blocks, threads, 0, stream>>>(
      row_part, n_chunks, col_part, n_row_tiles, n, nf, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
