// Ewald real-space pair sweep for Hopper (sm_90a), float32.
//
//   K4 ewald_real_sweep  replaces _kernel_ewald_sym
//                        (rigid_body_light_tpu/ops/ewald_pallas.py:81):
//                        U_i = Σ_{j≠i} [A(r)·I + B(r)·r̂r̂]·F_j under 3-D
//                        minimum image, every unordered pair i<j once,
//                        applied forward (into row i) and transposed (into
//                        column j).  1 or 2 RHS sharing the pair fields.
//   ewald_real_slab      its ordered slab form for the distributed ring
//                        (rigid_body_light_tpu_torch/ops/ewald.py::
//                        mobility_apply_local): U_i = Σ_j [A·I + B·r̂r̂]·F_j
//                        for rows i of one block against the columns j of
//                        another, at global offsets, the pair whose global
//                        ids are equal left out.  The JAX package sweeps
//                        these blocks in plain XLA (ewald.py:788
//                        real_space_block); the ring's diagonal block is
//                        K4's own sweep.
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
// the operands are 24-36 bytes per blob.
//
// Work items.  The earlier design ran a grid of 128-row tiles × 512-column
// chunks: at 10,272 blobs half of its 81 × 21 blocks exited at once and the
// ~900 that worked all fitted on the card in one uneven wave (6.8 per SM on
// average), so the launch lasted as long as the fullest SM; over 4× the
// blobs the same code ran 1.5× faster per pair.  Now a block takes one
// item, a 128 × 128 tile pair (I, J ≥ I) of the upper triangle: ⌈n/128⌉
// diagonal items first (half of their pairs are kept, j > i, and a warp
// skips the sub-tiles left of its rows), then the full items in row-major
// order, so the cheap items lead and the tail is made of equal full ones.
// At the periodic slice that is 3,321 items for a card that holds ~2,000
// blocks at once.  The block decodes its item from its index
// (tile_items.cuh, shared with K1).
//
// The Clenshaw loop.  Each chain is a serial run of D dependent FMAs, and
// a step costs one 8-byte shared read (A_j, B_j) besides the two FADD and
// two FFMA of the two chains.  A thread evaluates kPairs pairs side by side
// (columns c and c + 32 of the item): 2·kPairs independent chains, and
// where a warp's pairs share their segment (nearly always: the long
// segment covers r ≥ 2a), one shared read serves all of a thread's chains.
// On an H100 at 700 W, at the periodic slice (PERF.md §6): two pairs a
// thread took 1.209 / 1.318 ms (1 / 2 RHS) against one pair's 1.314 /
// 1.393 ms, with 55 / 61 registers (9 / 8 blocks an SM) against 40 / 48
// (12 / 10), no spills: the independent chains and the shared read are
// worth more than the resident warps they cost.  The item count showed in
// the same runs: the slice reached 24.4 TFLOP/s against 26.1 over 4× the
// blobs, where the earlier grid had 15.5 against 21.9.
//
// The coefficients.  The TPU kernel bakes them into the program and picks
// each by two selects per Clenshaw step.  Here the segment is chosen once
// per pair and the table lives in shared memory as float2 (A_j, B_j) at
// [j][segment] (4 slots per j): lanes of one segment read one address (a
// broadcast), and lanes of different segments read neighbouring banks.
// The table arrives by pointer with every launch, with its degree (at most
// kMaxDeg); the wrapper keeps one device copy per operator, so operators
// with different boxes never read each other's coefficients.
//
// Cross-block accumulation: as K1 (rpy_pair_sweep.cu), a block walks the
// items of one unit of group pairs and keeps a row partial (128 rows) and
// a column partial (128 columns) a tile of its groups, each element
// written by one thread of one block, so the scratch grows as n (one
// partial an item, before, grew as n²); lane l visits column (l + s) mod
// 32 at step s, so each warp adds its transposed terms into its own shared
// column accumulator.  A second pass (tile_items.cuh) sums, for every
// blob, the partials of its tile in a fixed order.  No atomics: launches
// are bitwise repeatable; up to 65,536 blobs a unit is one item and the
// launch is the one-item-a-block design's, bit for bit.
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

#include "tile_items.cuh"

namespace {

constexpr int kTile = tile_items::kTile;  // rows and columns of an item,
                                         // one row a thread
constexpr int kSub = 32;      // columns per rotation sub-tile
constexpr int kWarps = kTile / 32;
constexpr int kPairs = 2;     // pairs a thread evaluates side by side
constexpr int kMaxDeg = 128;  // largest Chebyshev degree the table holds

// Per-launch constants, passed by value (they live in the constant bank).
struct SweepConsts {
  float box[3];
  float inv_box[3];
  float b1, b2;        // segment edges: segment = (r >= b1) + (r >= b2)
  float lo[3];         // left edge of each segment
  float two_inv_w[3];  // 2 / width of each segment
};

// A(r), B(r) of P pairs by Clenshaw on their segments' coefficients.
template <int P>
__device__ __forceinline__ void clenshaw(const float2* s_coef, int deg,
                                         const int (&seg)[P],
                                         const float (&x)[P], float (&A)[P],
                                         float (&B)[P]) {
  float ya1[P], ya2[P], yb1[P], yb2[P], two_x[P];
  bool same = true;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ya1[p] = ya2[p] = yb1[p] = yb2[p] = 0.0f;
    two_x[p] = 2.0f * x[p];
    same = same && seg[p] == seg[0];
  }
  // b_j = c_j + 2x·b_{j+1} − b_{j+2}, both chains of every pair
  if (P == 1 || __all_sync(0xffffffffu, same)) {
    const float2* cs = s_coef + seg[0];
#pragma unroll 4
    for (int q = deg; q >= 1; --q) {
      const float2 cq = cs[4 * q];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float ya = fmaf(two_x[p], ya1[p], cq.x - ya2[p]);
        const float yb = fmaf(two_x[p], yb1[p], cq.y - yb2[p]);
        ya2[p] = ya1[p]; ya1[p] = ya;
        yb2[p] = yb1[p]; yb1[p] = yb;
      }
    }
  } else {
#pragma unroll 4
    for (int q = deg; q >= 1; --q) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 cq = s_coef[4 * q + seg[p]];
        const float ya = fmaf(two_x[p], ya1[p], cq.x - ya2[p]);
        const float yb = fmaf(two_x[p], yb1[p], cq.y - yb2[p]);
        ya2[p] = ya1[p]; ya1[p] = ya;
        yb2[p] = yb1[p]; yb1[p] = yb;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float2 c0 = s_coef[seg[p]];
    A[p] = fmaf(x[p], ya1[p], c0.x - ya2[p]);
    B[p] = fmaf(x[p], yb1[p], c0.y - yb2[p]);
  }
}

// GROUPED = false: the one-item unit of G = T (up to 65,536 blobs),
// compiled without the walk (as K1).
template <int NRHS, bool GROUPED>
__global__ void __launch_bounds__(kTile)
ewald_item_kernel(const float* __restrict__ pos,     // (n, 3)
                  const float* __restrict__ force,   // (NRHS, n, 3)
                  int n, tile_items::Groups g, SweepConsts cst,
                  const float2* __restrict__ coef,   // (deg+1, 4)
                  int deg,
                  float* __restrict__ row_part,   // (units, S, 3·NRHS, 128)
                  float* __restrict__ col_part) {  // (units, S, 3·NRHS, 128)
  constexpr int NF = 3 * NRHS;
  __shared__ float2 s_coef[(kMaxDeg + 1) * 4];
  __shared__ float s_pos[3][kTile];
  __shared__ float s_f[NF][kTile];
  __shared__ float s_acc[kWarps][NF][kTile];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const tile_items::Unit u = tile_items::unit_of(blockIdx.x, g);
  const int I1 = GROUPED ? u.I1 : u.I0 + 1;
  const int J1 = GROUPED ? u.J1 : u.J0 + 1;

  for (int idx = t; idx < (deg + 1) * 4; idx += kTile) s_coef[idx] = coef[idx];

  for (int I = u.I0; I < I1; ++I) {
    const int i = I * kTile + t;
    const bool row_ok = i < n;
    float xR = 0.0f, yR = 0.0f, zR = 0.0f;
    float fR[NF];
    float acc[NF];
#pragma unroll
    for (int q = 0; q < NF; ++q) { fR[q] = 0.0f; acc[q] = 0.0f; }
    if (row_ok) {
      xR = pos[3 * i]; yR = pos[3 * i + 1]; zR = pos[3 * i + 2];
#pragma unroll
      for (int q = 0; q < NF; ++q)
        fR[q] = force[((size_t)(q / 3) * n + i) * 3 + q % 3];
    }

    for (int J = GROUPED ? u.first_col(I) : u.J0; J < J1; ++J) {
      const bool diag = I == J;
      if (GROUPED) __syncthreads();  // the previous item's stage is read
      {
        const int j = J * kTile + t;
        const bool ok = j < n;
        s_pos[0][t] = ok ? pos[3 * j] : 0.0f;
        s_pos[1][t] = ok ? pos[3 * j + 1] : 0.0f;
        s_pos[2][t] = ok ? pos[3 * j + 2] : 0.0f;
#pragma unroll
        for (int k = 0; k < NRHS; ++k)
#pragma unroll
          for (int d = 0; d < 3; ++d)
            s_f[3 * k + d][t] = ok ? force[((size_t)k * n + j) * 3 + d] : 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
#pragma unroll
          for (int q = 0; q < NF; ++q) s_acc[w][q][t] = 0.0f;
      }
      const int n_cols = min(kTile, n - J * kTile);
      __syncthreads();  // the stage and the table are written

      for (int q0 = 0; q0 < kTile; q0 += kPairs * kSub) {
        // diagonal item: this warp's rows are all right of these columns
        if (diag && q0 + kPairs * kSub <= warp * 32) continue;
        for (int s = 0; s < kSub; ++s) {
          int c[kPairs], seg[kPairs];
          bool valid[kPairs];
          bool any = false;
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            c[p] = q0 + p * kSub + ((lane + s) & (kSub - 1));
            valid[p] = row_ok && c[p] < n_cols && (!diag || c[p] > t);
            any = any || valid[p];
          }
          if (!__any_sync(0xffffffffu, any)) continue;
          float dx[kPairs], dy[kPairs], dz[kPairs], x[kPairs], inv_r2[kPairs];
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            dx[p] = xR - s_pos[0][c[p]];
            dy[p] = yR - s_pos[1][c[p]];
            dz[p] = zR - s_pos[2][c[p]];
            dx[p] -= cst.box[0] * rintf(dx[p] * cst.inv_box[0]);
            dy[p] -= cst.box[1] * rintf(dy[p] * cst.inv_box[1]);
            dz[p] -= cst.box[2] * rintf(dz[p] * cst.inv_box[2]);
            float r2 = fmaxf(dx[p] * dx[p] + dy[p] * dy[p] + dz[p] * dz[p],
                             1e-24f);
            r2 = valid[p] ? r2 : 1.0f;
            const float r = sqrtf(r2);
            inv_r2[p] = 1.0f / r2;
            const bool in1 = r >= cst.b1, in2 = r >= cst.b2;
            seg[p] = (int)in1 + (int)in2;
            const float lo = in2 ? cst.lo[2] : (in1 ? cst.lo[1] : cst.lo[0]);
            const float two_inv_w = in2 ? cst.two_inv_w[2]
                                        : (in1 ? cst.two_inv_w[1]
                                               : cst.two_inv_w[0]);
            x[p] = fminf(fmaxf((r - lo) * two_inv_w - 1.0f, -1.0f), 1.0f);
          }
          float A[kPairs], B[kPairs];
          clenshaw<kPairs>(s_coef, deg, seg, x, A, B);
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const float Ap = valid[p] ? A[p] : 0.0f;
            const float Bh = valid[p] ? B[p] * inv_r2[p] : 0.0f;  // r̂r̂ = d dᵀ/r²
            const int cp = c[p];
#pragma unroll
            for (int k = 0; k < NRHS; ++k) {
              const float fx = s_f[3 * k][cp], fy = s_f[3 * k + 1][cp],
                          fz = s_f[3 * k + 2][cp];
              const float bdF = Bh * (dx[p] * fx + dy[p] * fy + dz[p] * fz);
              acc[3 * k] += Ap * fx + bdF * dx[p];
              acc[3 * k + 1] += Ap * fy + bdF * dy[p];
              acc[3 * k + 2] += Ap * fz + bdF * dz[p];
              const float bdR = Bh * (dx[p] * fR[3 * k] + dy[p] * fR[3 * k + 1]
                                      + dz[p] * fR[3 * k + 2]);
              s_acc[warp][3 * k][cp] += Ap * fR[3 * k] + bdR * dx[p];
              s_acc[warp][3 * k + 1][cp] += Ap * fR[3 * k + 1] + bdR * dy[p];
              s_acc[warp][3 * k + 2][cp] += Ap * fR[3 * k + 2] + bdR * dz[p];
            }
          }
          __syncwarp();
        }
      }
      __syncthreads();  // every warp's column accumulator is complete

      // thread t: column t of tile J, written at the unit's first row
      float* colp = tile_items::slot(col_part, blockIdx.x, J - u.J0, g, NF);
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_acc[w][q][t];
        tile_items::store_col(colp + q * kTile + t, v, !GROUPED || I == u.I0);
      }
    }

    // thread t: row t of tile I, once its items are swept
    float* rowp = tile_items::slot(row_part, blockIdx.x, I - u.I0, g, NF);
#pragma unroll
    for (int q = 0; q < NF; ++q) rowp[q * kTile + t] = acc[q];
  }
}

template <int NRHS>
void launch_item(const tile_items::Groups& g, cudaStream_t stream,
                 const float* pos, const float* force, int n,
                 const SweepConsts& cst, const float2* coef, int deg,
                 float* row_part, float* col_part) {
  if (g.n_groups < g.n_tiles)
    ewald_item_kernel<NRHS, true><<<g.units, kTile, 0, stream>>>(
        pos, force, n, g, cst, coef, deg, row_part, col_part);
  else
    ewald_item_kernel<NRHS, false><<<g.units, kTile, 0, stream>>>(
        pos, force, n, g, cst, coef, deg, row_part, col_part);
}

// The slab form.  Block (row block blockIdx.x, column chunk blockIdx.y) of
// kSlabRows rows × kSlabChunk columns, K2's ordered layout
// (rpy_pair_sweep.cu::pair_sweep_ordered_kernel): lane l owns rows l and
// l + 32 of the row block, and their two Clenshaw chains run side by side
// (K4's two pairs a thread; the rows of a warp share a column, so their
// segment nearly always, and one shared read serves both chains); warp w
// sweeps columns [64w, 64w + 64) of the chunk.  Every pair is evaluated
// from its row's side only (an ordered sweep), with K4's wrap, distance,
// segment map and Clenshaw, and a pair is live iff its row is in range and
// its global ids differ, so a block that overlaps its rows is right too.
// The 4 warps' sums are added in a fixed order into the chunk's partial
// (one writer per element), and a second pass sums the chunks in order:
// no atomics, launches repeat bitwise.
constexpr int kSlabRows = 64;
constexpr int kSlabChunk = 256;
constexpr int kSlabWarps = 4;
constexpr int kSlabWarpCols = kSlabChunk / kSlabWarps;
constexpr int kSlabRowsPerLane = kSlabRows / 32;

template <int NRHS>
__global__ void __launch_bounds__(kSlabWarps * 32)
ewald_slab_kernel(const float* __restrict__ rows_pos,    // (n_rows, 3)
                  int n_rows, int row0,
                  const float* __restrict__ cols_pos,    // (n_cols, 3)
                  const float* __restrict__ cols_force,  // (NRHS, n_cols, 3)
                  int n_cols, int col0, SweepConsts cst,
                  const float2* __restrict__ coef,       // (deg+1, 4)
                  int deg,
                  float* __restrict__ part) {  // (chunks, NRHS, n_rows, 3)
  constexpr int NF = 3 * NRHS;
  constexpr int RL = kSlabRowsPerLane;
  __shared__ float2 s_coef[(kMaxDeg + 1) * 4];
  __shared__ float s_pos[3][kSlabChunk];
  __shared__ float s_f[NF][kSlabChunk];
  __shared__ float s_red[kSlabWarps][NF][kSlabRows];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int c0 = blockIdx.y * kSlabChunk;
  const int n_c = min(kSlabChunk, n_cols - c0);

  for (int idx = t; idx < (deg + 1) * 4; idx += kSlabWarps * 32)
    s_coef[idx] = coef[idx];
  for (int c = t; c < kSlabChunk; c += kSlabWarps * 32) {
    const int j = c0 + c;
    const bool ok = j < n_cols;
#pragma unroll
    for (int d = 0; d < 3; ++d) s_pos[d][c] = ok ? cols_pos[3 * j + d] : 0.0f;
#pragma unroll
    for (int k = 0; k < NRHS; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s_f[3 * k + d][c] =
            ok ? cols_force[((size_t)k * n_cols + j) * 3 + d] : 0.0f;
  }
  float xR[RL], yR[RL], zR[RL];
  bool row_ok[RL];
  int gi[RL];
  float acc[RL][NF];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int i = blockIdx.x * kSlabRows + r * 32 + lane;
    row_ok[r] = i < n_rows;
    gi[r] = row0 + i;
    xR[r] = row_ok[r] ? rows_pos[3 * i] : 0.0f;
    yR[r] = row_ok[r] ? rows_pos[3 * i + 1] : 0.0f;
    zR[r] = row_ok[r] ? rows_pos[3 * i + 2] : 0.0f;
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[r][q] = 0.0f;
  }
  __syncthreads();  // the stage and the table are written

  // warp-uniform bounds: every lane runs every column (the Clenshaw
  // helper's vote needs the whole warp)
  const int c_end = min(n_c, (w + 1) * kSlabWarpCols);
  for (int c = w * kSlabWarpCols; c < c_end; ++c) {
    const float xC = s_pos[0][c], yC = s_pos[1][c], zC = s_pos[2][c];
    const int gj = col0 + c0 + c;
    float dx[RL], dy[RL], dz[RL], x[RL], inv_r2[RL];
    int seg[RL];
    bool valid[RL];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      valid[r] = row_ok[r] && gi[r] != gj;
      dx[r] = xR[r] - xC;
      dy[r] = yR[r] - yC;
      dz[r] = zR[r] - zC;
      dx[r] -= cst.box[0] * rintf(dx[r] * cst.inv_box[0]);
      dy[r] -= cst.box[1] * rintf(dy[r] * cst.inv_box[1]);
      dz[r] -= cst.box[2] * rintf(dz[r] * cst.inv_box[2]);
      float r2 = fmaxf(dx[r] * dx[r] + dy[r] * dy[r] + dz[r] * dz[r],
                       1e-24f);
      r2 = valid[r] ? r2 : 1.0f;
      const float rr = sqrtf(r2);
      inv_r2[r] = 1.0f / r2;
      const bool in1 = rr >= cst.b1, in2 = rr >= cst.b2;
      seg[r] = (int)in1 + (int)in2;
      const float lo = in2 ? cst.lo[2] : (in1 ? cst.lo[1] : cst.lo[0]);
      const float two_inv_w = in2 ? cst.two_inv_w[2]
                                  : (in1 ? cst.two_inv_w[1]
                                         : cst.two_inv_w[0]);
      x[r] = fminf(fmaxf((rr - lo) * two_inv_w - 1.0f, -1.0f), 1.0f);
    }
    float A[RL], B[RL];
    clenshaw<RL>(s_coef, deg, seg, x, A, B);
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const float Ap = valid[r] ? A[r] : 0.0f;
      const float Bh = valid[r] ? B[r] * inv_r2[r] : 0.0f;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float fx = s_f[3 * k][c], fy = s_f[3 * k + 1][c],
                    fz = s_f[3 * k + 2][c];
        const float bdF = Bh * (dx[r] * fx + dy[r] * fy + dz[r] * fz);
        acc[r][3 * k] += Ap * fx + bdF * dx[r];
        acc[r][3 * k + 1] += Ap * fy + bdF * dy[r];
        acc[r][3 * k + 2] += Ap * fz + bdF * dz[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int q = 0; q < NF; ++q) s_red[w][q][r * 32 + lane] = acc[r][q];
  __syncthreads();
  for (int idx = t; idx < NF * kSlabRows; idx += kSlabWarps * 32) {
    const int q = idx / kSlabRows;
    const int rr = idx % kSlabRows;
    const int i = blockIdx.x * kSlabRows + rr;
    if (i >= n_rows) continue;
    float v = s_red[0][q][rr];
#pragma unroll
    for (int s = 1; s < kSlabWarps; ++s) v += s_red[s][q][rr];
    part[(((size_t)blockIdx.y * NRHS + q / 3) * n_rows + i) * 3 + q % 3] = v;
  }
}

// The slab's second pass: out[e] = Σ_chunk part[chunk][e] in chunk order,
// for the per_chunk = nrhs·n_rows·3 elements e.
__global__ void slab_sum_chunks_kernel(const float* __restrict__ part,
                                       int n_chunks, int per_chunk,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_chunk) return;
  float v = 0.0f;
  for (int c = 0; c < n_chunks; ++c) v += part[(size_t)c * per_chunk + e];
  out[e] = v;
}

SweepConsts unpack_consts(const float* consts) {
  SweepConsts cst;
  for (int d = 0; d < 3; ++d) {
    cst.box[d] = consts[d];
    cst.inv_box[d] = consts[3 + d];
    cst.lo[d] = consts[8 + d];
    cst.two_inv_w[d] = consts[11 + d];
  }
  cst.b1 = consts[6];
  cst.b2 = consts[7];
  return cst;
}

}  // namespace

extern "C" {

// The item edge and most groups the wrapper sizes its scratch by, and the
// largest degree the shared table holds.
int ewald_sweep_tile() { return kTile; }
int ewald_sweep_max_degree() { return kMaxDeg; }
int ewald_sweep_max_groups() { return tile_items::kMaxGroups; }

// K4: out (nrhs, n, 3) = Σ_{j≠i} [A·I + B·r̂r̂]·F_j over unordered pairs.
// consts: 14 host floats (box[3], inv_box[3], b1, b2, lo[3], two_inv_w[3]),
// passed by value.  coef: device (deg+1, 4, 2) floats, [j][segment] =
// (A_j, B_j), slot 3 unused.  row_part and col_part hold units·S·3·nrhs·128
// floats each (tile_items::groups_of; scratch, fully overwritten).
int ewald_real_sweep(const float* pos, const float* force, int n, int nrhs,
                     const float* consts, const float* coef, int deg,
                     float* row_part, float* col_part, float* out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (deg < 0 || deg > kMaxDeg) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const SweepConsts cst = unpack_consts(consts);
  const tile_items::Groups g = tile_items::groups_of(n);
  const float2* coef2 = reinterpret_cast<const float2*>(coef);
  if (nrhs == 1)
    launch_item<1>(g, stream, pos, force, n, cst, coef2, deg, row_part,
                   col_part);
  else
    launch_item<2>(g, stream, pos, force, n, cst, coef2, deg, row_part,
                   col_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tile_items::sum_items(row_part, col_part, n, nrhs, out, stream));
}

// The slab form's rows and columns a block.
int ewald_slab_rows() { return kSlabRows; }
int ewald_slab_chunk() { return kSlabChunk; }

// The slab form: out (nrhs, n_rows, 3) = Σ_j [A·I + B·r̂r̂]·F_j over every
// column j whose global id (col0 + j) differs from the row's (row0 + i).
// consts and coef as ewald_real_sweep's.  part holds
// ⌈n_cols/256⌉·nrhs·n_rows·3 floats (scratch, fully overwritten).
int ewald_real_slab(const float* rows_pos, int n_rows, int row0,
                    const float* cols_pos, const float* cols_force,
                    int n_cols, int col0, int nrhs, const float* consts,
                    const float* coef, int deg, float* part, float* out,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (deg < 0 || deg > kMaxDeg) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const int n_chunks = n_cols > 0 ? (n_cols + kSlabChunk - 1) / kSlabChunk
                                  : 0;
  if (n_chunks > 0) {
    const SweepConsts cst = unpack_consts(consts);
    const float2* coef2 = reinterpret_cast<const float2*>(coef);
    const dim3 grid((n_rows + kSlabRows - 1) / kSlabRows, n_chunks);
    if (nrhs == 1)
      ewald_slab_kernel<1><<<grid, kSlabWarps * 32, 0, stream>>>(
          rows_pos, n_rows, row0, cols_pos, cols_force, n_cols, col0, cst,
          coef2, deg, part);
    else
      ewald_slab_kernel<2><<<grid, kSlabWarps * 32, 0, stream>>>(
          rows_pos, n_rows, row0, cols_pos, cols_force, n_cols, col0, cst,
          coef2, deg, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_chunk = nrhs * n_rows * 3;
  const int threads = 256;
  slab_sum_chunks_kernel<<<(per_chunk + threads - 1) / threads, threads, 0,
                           stream>>>(part, n_chunks, per_chunk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
