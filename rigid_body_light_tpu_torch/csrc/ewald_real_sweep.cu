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
//   ewald_tile_kernel    "K4 tiles": the balanced split's cutoff sweep over
//                        sorted neighbor tiles (its own note is below).
//                        It replaces no Pallas kernel: the JAX package
//                        sweeps these tiles in plain XLA
//                        (rigid_body_light_tpu/ops/ewald_cells.py:122
//                        _cell_sweep).
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

// ---------------------------------------------------------------------
// The slab form: K4's pair terms as an ordered rows × columns sweep.
//
// Contract: out (k, n_rows, 3) = Σ_j [A(r)·I + B(r)·r̂r̂]·F_j for the rows i
// of one block of blobs against the columns j of another, at global
// offsets (row0 + i, col0 + j), under K4's 3-D minimum image, the pair of
// equal global ids left out.  It replaces K4's pair terms
// (rigid_body_light_tpu/ops/ewald_pallas.py:81 _kernel_ewald_sym) on the
// distributed ring's off-diagonal blocks, which the JAX package sweeps in
// plain XLA (rigid_body_light_tpu/ops/ewald.py:788 real_space_block); the
// ring's diagonal block is K4's own sweep.  Its main shape is the ring's
// n/D × n/D block: 2,568 × 2,568 at D = 4 and 5,136 × 5,136 at D = 2 for
// the periodic slice's 10,272 blobs.
//
// What bounds it: arithmetic.  Every ordered pair costs K4's fields (36
// flop, an IEEE sqrt and division, two Clenshaw chains of degree D: 6·D,
// 486 at the slice's D = 81) and 18 flop a RHS for its one direction; the
// operands are 24-36 bytes a blob, a few MB that stay in L2.  As for K4
// tiles, the work is scalar float32 FMA chains with no matrix product, so
// wgmma and the tensor cores do not apply, and TMA or cp.async staging
// would not move the time.  A count of issued instructions gives ~430 a pair
// (a FADD and an FFMA a Clenshaw step and chain, one shared read a step for
// a lane's rows, the prologue and the apply) against the bound's 540
// flop, so ~1.6-1.9× its bound at the card's sustained FMA clock is the
// practical floor.
//
// Design.  A block is kSlabRows = 128 rows × kSlabChunk = 32 columns, 4
// warps: the D = 4 ring's 2,568 × 2,568 is 21 × 81 = 1,701 blocks, 12.9
// an SM, the D = 2 ring's 5,136 × 5,136 41 × 161.  Lane l owns rows l,
// l + 32, l + 64 and l + 96 of the row block, and their four Clenshaw
// chain pairs run side by side (the rows of a warp share a column, so
// nearly always a segment, and one shared read of (A_q, B_q) serves all
// eight chains); warp w sweeps columns w, w + 4, … of the chunk, so a
// ragged chunk stays balanced over the warps.  __launch_bounds__(128, 5)
// holds it to 96 registers: 5 blocks, 20 warps, an SM (ptxas reports a
// 32-byte spill at 2 RHS, which costs nothing measurable, below).  Every
// pair is evaluated from its row's side only, and a pair is live iff its
// row is in range and its global ids differ, so a block that overlaps its
// rows is right too.  The warps' sums are added in a fixed order into the
// chunk's partial (one writer per element), and a second pass sums the
// chunks in order: no atomics, launches repeat bitwise.  The scratch is
// one (k, n_rows, 3) partial a chunk, ⌈n_cols/32⌉·k·n_rows·12 bytes: 2.5
// MB a RHS at the D = 4 ring, 9.9 MB at the D = 2 ring, 39.6 MB at the
// slice's n × n, 313 MB at a 28,890² block (115,560 blobs over 4 ranks),
// 8× what 256-column chunks took.
//
// Why (scripts/torch_sweep_turns.py --only "K4 slab": the kernel alone at
// the ring's blocks of the periodic slice's positions, in turns against
// copies of this file with one constant or the row stage changed, two
// calls; one H100 80GB HBM3 at 700.00 W; ms at 1 / 2 RHS, PERF.md §6).
// The earlier design, 64 × 256 blocks of 4 warps with 64 contiguous
// columns each, gave the D = 4 ring's block 41 × 11 = 451 blocks for 132
// SMs (4 on the busiest against a mean of 3.4, the 11th chunk 8 columns
// wide), at most 16 warps an SM: 0.1963-0.1982 / 0.2032-0.2047 there,
// 3.7× its bound.
// This design 0.1341-0.1349 / 0.1385-0.1392 (2.5×); at the D = 2 ring
// 0.4861-0.4901 / 0.5043-0.5051 (2.3×).  At the D = 4 ring:
//   - kSlabChunk = 64: 0.1449-0.1464 / 0.1499-0.1509, 8% slower (at the
//     D = 2 ring 0.4859-0.4891 / 0.4993-0.5019, at most 1% faster);
//   - kSlabRowsPerLane = 2 (64-row blocks, 61 / 67 registers):
//     0.1520-0.1596 / 0.1570-0.1590;
//   - kSlabMinBlocks = 1 (105 / 117 registers, no spill, 4 blocks an
//     SM): 0.1438-0.1444 / 0.1491-0.1536;
//   - the rows' positions staged in shared memory, their ids derived (93
//     / 96 registers, no spill): 0.1513-0.1522 / 0.1387-0.1388, so the
//     spill costs nothing at 2 RHS and the stage 13% at 1 RHS; at 6
//     blocks an SM so (79 / 80 registers, a 48-byte spill at 2 RHS)
//     0.1381-0.1384 / 0.1452;
//   - the chunk sum, a second launch, 3.1 µs of a ~131-µs call (4.9-5.4
//     µs at the D = 2 ring; torch.profiler): kept.
constexpr int kSlabWarps = 4;
constexpr int kSlabRowsPerLane = 4;
constexpr int kSlabRows = 32 * kSlabRowsPerLane;
constexpr int kSlabChunk = 32;
constexpr int kSlabMinBlocks = 5;  // __launch_bounds__' resident blocks

template <int NRHS>
__global__ void __launch_bounds__(kSlabWarps * 32, kSlabMinBlocks)
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
  for (int c = t; c < n_c; c += kSlabWarps * 32) {
    const int j = c0 + c;
#pragma unroll
    for (int d = 0; d < 3; ++d) s_pos[d][c] = cols_pos[3 * j + d];
#pragma unroll
    for (int k = 0; k < NRHS; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s_f[3 * k + d][c] = cols_force[((size_t)k * n_cols + j) * 3 + d];
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
  for (int c = w; c < n_c; c += kSlabWarps) {
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

// ---------------------------------------------------------------------
// K4 tiles: the balanced split's real part over sorted neighbor tiles.
//
// Contract: exactly ewald_cells._cell_sweep's (rigid_body_light_tpu_torch/
// ops/ewald_cells.py; the JAX package's ewald_cells.py:122).  The blobs
// arrive folded into the box, sorted into t tiles of 32 and padded
// (ewald_cells.sorted_tiles): positions (t·32, 3), blob ids (−1 for a
// pad), forces (k, t·32, 3), the neighbor lists nbr (t, M), the live
// tiles of each row first, ascending, then −1.  For the row tiles
// [t0, t0 + nt), out (k, nt·32, 3) = Σ_j [A(r)·I + B(r)·r̂r̂]·F_j over the
// columns j of the row's listed tiles where both ids are ≥ 0, they differ
// and r ≤ rc under the 3-D minimum image.  A and B come from one
// Chebyshev fit (monodisperse) or, in the POLY form, from the fit
// pair_map[species_i][species_j] of per-species-pair fits
// (ewald.make_poly_tables), by K4's Clenshaw.
//
// What bounds it: arithmetic, as K4.  At the balanced-split slice
// (115,560 blobs in L = 30, rc 3.5, degree 47) 39.7 M unordered pairs lie
// within rc; at K4's 36 + 6·D + 36·k flop an unordered pair that is 14.1 /
// 15.5 GFLOP at 1 / 2 RHS, 0.210 / 0.231 ms at 67 TFLOP/s.  The work is
// scalar float32 FMA chains (Clenshaw) with no matrix product, so wgmma
// and the tensor cores do not apply; the operands are ~40 bytes a blob,
// a few MB that stay in L2, so TMA or cp.async staging would not move the
// time.  What the design uses: the register file (a lane's two pairs, their
// four Clenshaw chains and its sums), shared memory for the fit tables
// (dynamic, up to kTileTableBytes) and each warp's stage, warp shuffles
// for the sums, and the hardware's block scheduler to balance the pairs.
//
// Design: a symmetric sweep over unordered tile pairs (K3's).
//   - The work list (ewald_cuda.tile_list: K3's list, tiles.tile_pairs,
//     sliced by tiles.slice_pairs) holds each unordered pair of listed
//     tiles (a, b ≥ a) once, in list order.  The balanced split's lists
//     are symmetric (tiles.bbox_adjacency: its centre difference is exactly
//     antisymmetric, rint odd) and min_image is odd, so a pair's fields are
//     evaluated once, from a's side, and applied twice: [A·I + B·r̂r̂]·F_j
//     into row i and the same block times F_i into column j.  The ordered
//     design before it (rows against up to 16 live list slots) evaluated
//     each kept pair from both sides (2.840 / 3.065 ms, PERF.md §6).
//   - One warp a tile pair, 4 warps a block, one block per 4 pairs: the
//     block scheduler balances pairs of very different work (a persistent
//     grid sized by occupancy took 1.2975 / 1.4404 ms against this
//     grid's 1.2045 / 1.3420 in one run).  The warp stages both tiles
//     (position, id, species, forces) in its shared slice.
//   - A warp step is an 8 × 8 sub-block (R, C) of the pair's 32 × 32
//     candidates: lane (ρ, γ) = (l & 3, l >> 2) evaluates rows 8R + ρ and
//     8R + ρ + 4 against column 8C + γ, K4's two Clenshaw chains side by
//     side, one coefficient read for both where their fit and segment
//     agree.  A sub-block whose 8-blob sub-tiles' bounding boxes lie more
//     than rc apart under the minimum image is skipped before its
//     distances (sub_block_mask), one where no lane keeps a pair after
//     them (a vote); a masked pair in a kept step adds an exact 0 through
//     a select.  K1's and K3's column rotation (lane l at columns (l + s)
//     mod 32 and (l + s + 16) mod 32 at step s) spreads a step over the
//     whole 32 × 32 block: at phase 44's positions 49.6% of its executed
//     pair slots carry a kept pair against the sub-blocks' 64.1%, and it
//     took 1.8017 / 1.9798 ms against the sub-blocks' 1.5819 / 1.6762 in
//     one run (before the box test, which took them from 1.6138 / 1.7587
//     to 1.5256 / 1.6757 in another).
//   - Sums, one writer an element, no atomics: a row's terms over the
//     sub-blocks' columns (C ascending, per γ) and then over its 8 γ lanes
//     by a butterfly; a column's over a sub-block's 8 rows by a butterfly
//     over its 4 ρ lanes and then over R ascending.  Each side of a pair
//     is so a sum of 32 terms, 8 of them in a tree: the slot-sum trick
//     (one running float32 sum over a row's hundreds of kept pairs loses
//     several times more against float64).  A diagonal pair (a, a) keeps
//     j > i (the sub-blocks left of the diagonal are skipped) and adds its
//     two sides.
//   - Partials: the row side of pair (a, b) at a's slot of b, the column
//     side at b's slot of a, the slots counted through the lists' live
//     entries (row_start, their prefix sum); each side only where its tile
//     lies in the slice [t0, t0 + nt) (K3's scheme: a pair across a
//     slice's edge is evaluated by both slices, each writing its side).
//     The second pass sums a tile's partials in its list's order, so
//     launches repeat bitwise and a slice is bitwise the same rows of the
//     whole launch.  The scratch is one partial a live slot of the slice
//     (207,210 at the slice: 80 / 159 MB at 1 / 2 RHS, where the ordered
//     design's grew as t·M: 313 / 627 MB), the count read to the host once
//     a list build.
//   - Numerics as before: min_image (the period off the coordinate past
//     L/2 before the difference), r² summed as the plain version sums it
//     (no contraction), IEEE sqrt and division, K4's segment map.
// Resources (ptxas, sm_90a): 64 / 67 registers at 1 / 2 RHS, 64 / 69 in
// the POLY form, no spills (__launch_bounds__'s 4 blocks an SM: without
// it the POLY form at 2 RHS spilled 16 bytes around the IEEE division's
// slow path); 11,264 / 17,408 bytes of static shared memory besides the
// table (1,568 bytes at degree 47).  On an H100 at 700 W, at the slice:
// 1.1956 / 1.3848 ms, 5.7× / 6.0× the bound, against the plain twin's
// 220.2 / 225.0 ms; the POLY form (degree 88) 0.6779 / 0.7429 ms
// (PERF.md §6).
constexpr int kTileRows = 32;   // blobs a tile
constexpr int kTileWarps = 4;   // warps a block, each on its own tile pairs
constexpr int kTileSub = 8;     // edge of a warp step's sub-block
constexpr int kTileSubs = kTileRows / kTileSub;
constexpr int kTileTableBytes = 196608;  // largest shared fit table
constexpr int kFitConsts = 8;   // b1, b2, lo[3], two_inv_w[3] a fit
constexpr unsigned kFull = 0xffffffffu;

struct TileConsts {
  float box[3];
  float inv_box[3];
  float rc;
};

// Dynamic shared bytes of the tables: coefficients (n_fits, deg+1, 4)
// float2, the fits' constants, the species-pair map.
int tile_table_bytes(int n_fits, int deg, int n_species) {
  return n_fits * (deg + 1) * 4 * 8 + n_fits * kFitConsts * 4
         + n_species * n_species * 4;
}

// a − b under the minimum image of a period L, for a, b folded into
// [0, L]: the image is K4's (rint of (a − b)/L), but the period is taken
// off the coordinate past L/2 before the difference (exact there, by
// Sterbenz), so a pair across the box's face has its small difference
// rounded once at its own scale, not at L's.  Odd in (a, b), ties
// included (rint is odd, and u − v = −(v − u) in IEEE arithmetic), so a
// pair's two sides see one separation, negated.
__device__ __forceinline__ float min_image(float a, float b, float L,
                                           float inv_L) {
  const float n = rintf((a - b) * inv_L);
  return n > 0.0f ? (a - L) - b : (n < 0.0f ? a - (b - L) : a - b);
}

// One warp's stage of a tile pair: the row tile a (side 0) and the
// column tile b (side 1), 32 blobs each.
template <int NF>
struct TileStage {
  float pos[2][3][kTileRows];
  float f[2][NF][kTileRows];
  int id[2][kTileRows];
  int sp[2][kTileRows];
  float row[NF][kTileRows];  // the row side's sums, row r of tile a
  float col[NF][kTileRows];  // the column side's sums, column c of tile b
};

// The pair (row r of tile a, column c of tile b): its separation d, 1/r²,
// Clenshaw argument and table base (fit and segment), and whether it is
// kept: both ids live and different, on a diagonal pair c > r, and
// r ≤ rc.  r² is summed as the plain sweep sums it (no contraction), 1
// for a masked pair and floored at 1e-24; IEEE square root and division;
// K4's segment map.
template <int NF, bool POLY>
__device__ __forceinline__ bool pair_setup(
    const TileStage<NF>& st, int r, int c, bool diag, const TileConsts& cst,
    const float* s_fit, const int* s_map, int n_species, int stride,
    float& dx, float& dy, float& dz, float& inv_r2, float& x, int& base) {
  dx = min_image(st.pos[0][0][r], st.pos[1][0][c], cst.box[0],
                 cst.inv_box[0]);
  dy = min_image(st.pos[0][1][r], st.pos[1][1][c], cst.box[1],
                 cst.inv_box[1]);
  dz = min_image(st.pos[0][2][r], st.pos[1][2][c], cst.box[2],
                 cst.inv_box[2]);
  float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                       __fmul_rn(dz, dz));
  const int idR = st.id[0][r], idC = st.id[1][c];
  const bool ok = idR >= 0 && idC >= 0 && idR != idC && (!diag || c > r);
  r2 = ok ? fmaxf(r2, 1e-24f) : 1.0f;
  const float rr = __fsqrt_rn(r2);
  inv_r2 = __fdiv_rn(1.0f, r2);
  const int fit = POLY ? s_map[st.sp[0][r] * n_species + st.sp[1][c]] : 0;
  const float* fc = s_fit + fit * kFitConsts;
  const bool in1 = rr >= fc[0], in2 = rr >= fc[1];
  const int seg = (int)in1 + (int)in2;
  x = fminf(fmaxf((rr - fc[2 + seg]) * fc[5 + seg] - 1.0f, -1.0f), 1.0f);
  base = fit * stride * 4 + seg;
  return ok && rr <= cst.rc;
}

// The pair's two applies, masked pairs an exact 0: row[] = [A·I + B·r̂r̂]
// ·F_c (into row r), col[] = the same block times F_r (into column c).
template <int NRHS, int NF>
__device__ __forceinline__ void pair_apply(const TileStage<NF>& st, int r,
                                           int c, bool valid, float A,
                                           float B, float dx, float dy,
                                           float dz, float inv_r2,
                                           float (&row)[NF],
                                           float (&col)[NF]) {
  const float Ap = valid ? A : 0.0f;
  const float Bh = valid ? B * inv_r2 : 0.0f;  // r̂r̂ = d dᵀ/r²
#pragma unroll
  for (int k = 0; k < NRHS; ++k) {
    const float fx = st.f[1][3 * k][c], fy = st.f[1][3 * k + 1][c],
                fz = st.f[1][3 * k + 2][c];
    const float bdF = Bh * (dx * fx + dy * fy + dz * fz);
    row[3 * k] = Ap * fx + bdF * dx;
    row[3 * k + 1] = Ap * fy + bdF * dy;
    row[3 * k + 2] = Ap * fz + bdF * dz;
    const float gx = st.f[0][3 * k][r], gy = st.f[0][3 * k + 1][r],
                gz = st.f[0][3 * k + 2][r];
    const float bdR = Bh * (dx * gx + dy * gy + dz * gz);
    col[3 * k] = Ap * gx + bdR * dx;
    col[3 * k + 1] = Ap * gy + bdR * dy;
    col[3 * k + 2] = Ap * gz + bdR * dz;
  }
}

// Which of the pair's 16 sub-blocks (R, C) can keep a pair, bit 4R + C:
// the 8-blob sub-tiles' bounding boxes against each other under the
// minimum image (the centre difference wrapped, less the half extents,
// less a margin of 1e-5·L for float32 rounding: a box test can only keep
// more than the pair test).  Called by the whole warp.
template <int NF>
__device__ __forceinline__ unsigned sub_block_mask(const TileStage<NF>& st,
                                                   const TileConsts& cst,
                                                   int lane) {
  const int R = (lane >> 2) & (kTileSubs - 1), C = lane & (kTileSubs - 1);
  float g2 = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float lo[2], hi[2];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      lo[side] = hi[side] = st.pos[side][d][lane];
#pragma unroll
      for (int off = 1; off < kTileSub; off <<= 1) {
        lo[side] = fminf(lo[side], __shfl_xor_sync(kFull, lo[side], off));
        hi[side] = fmaxf(hi[side], __shfl_xor_sync(kFull, hi[side], off));
      }
    }
    const float loR = __shfl_sync(kFull, lo[0], kTileSub * R);
    const float hiR = __shfl_sync(kFull, hi[0], kTileSub * R);
    const float loC = __shfl_sync(kFull, lo[1], kTileSub * C);
    const float hiC = __shfl_sync(kFull, hi[1], kTileSub * C);
    float dc = 0.5f * (loR + hiR) - 0.5f * (loC + hiC);
    dc -= cst.box[d] * rintf(dc * cst.inv_box[d]);
    const float g = fmaxf(fabsf(dc) - 0.5f * (hiR - loR) - 0.5f * (hiC - loC)
                              - 1e-5f * cst.box[d],
                          0.0f);
    g2 += g * g;
  }
  return __ballot_sync(kFull, g2 <= cst.rc * cst.rc) & 0xffffu;
}

// (4 blocks an SM at least: without it ptxas spills 16 bytes in the POLY
// form at 2 RHS around the IEEE division's slow path)
template <int NRHS, bool POLY>
__global__ void __launch_bounds__(kTileWarps * 32, 4)
ewald_tile_kernel(const float* __restrict__ pos,      // (n_pad, 3)
                  const int* __restrict__ ids,        // (n_pad,)
                  const float* __restrict__ force,    // (NRHS, n_pad, 3)
                  const int* __restrict__ species,    // (n_pad,), POLY
                  const int4* __restrict__ pairs,     // (≥ cap, 4)
                  const int* __restrict__ n_pairs, int cap,
                  const int* __restrict__ row_start,  // (t + 1,)
                  int n_pad, int t0, int nt, TileConsts cst,
                  const float2* __restrict__ coef,    // (n_fits, deg+1, 4)
                  const float* __restrict__ fit_consts,  // (n_fits, 8)
                  int n_fits, int deg,
                  const int* __restrict__ pair_map,   // (S, S), POLY
                  int n_species,
                  float* __restrict__ part) {  // (cap, NRHS, 32, 3)
  constexpr int NF = 3 * NRHS;
  extern __shared__ float4 s_dyn[];
  float2* s_coef = reinterpret_cast<float2*>(s_dyn);
  const int n_coef = n_fits * (deg + 1) * 4;
  float* s_fit = reinterpret_cast<float*>(s_coef + n_coef);
  int* s_map = reinterpret_cast<int*>(s_fit + n_fits * kFitConsts);
  __shared__ TileStage<NF> s_stage[kTileWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int stride = deg + 1;
  const int count = min(*n_pairs, cap);
  if (blockIdx.x * kTileWarps >= count) return;  // the block has no pair
  for (int idx = t; idx < n_coef; idx += kTileWarps * 32)
    s_coef[idx] = coef[idx];
  for (int idx = t; idx < n_fits * kFitConsts; idx += kTileWarps * 32)
    s_fit[idx] = fit_consts[idx];
  if (POLY)
    for (int idx = t; idx < n_species * n_species; idx += kTileWarps * 32)
      s_map[idx] = pair_map[idx];
  __syncthreads();  // the tables are written

  TileStage<NF>& st = s_stage[warp];
  // lane (ρ, γ) = (l & 3, l >> 2) takes rows 8R + ρ and 8R + ρ + 4 against
  // column 8C + γ of sub-block (R, C); it sums row own_r (over all
  // columns) and column own_c (over all rows) into the stage
  const int rho = lane & 3, gam = lane >> 2;
  const int own_r = kTileSub * (gam >> 1) + rho + 4 * (gam & 1);
  const int own_c = kTileSub * rho + gam;
  const int item = blockIdx.x * kTileWarps + warp;  // one pair a warp
  if (item >= count) return;
  const int4 pr = pairs[item];
  const int a = pr.x, b = pr.y;
  const bool diag = a == b;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int j = (side ? b : a) * kTileRows + lane;
#pragma unroll
    for (int d = 0; d < 3; ++d) st.pos[side][d][lane] = pos[3 * j + d];
    st.id[side][lane] = ids[j];
    st.sp[side][lane] = POLY ? species[j] : 0;
#pragma unroll
    for (int k = 0; k < NRHS; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        st.f[side][3 * k + d][lane] =
            force[((size_t)k * n_pad + j) * 3 + d];
  }
#pragma unroll
  for (int q = 0; q < NF; ++q) st.row[q][lane] = st.col[q][lane] = 0.0f;
  __syncwarp();  // the stage is written
  const unsigned mask = sub_block_mask<NF>(st, cst, lane);

#pragma unroll 1
  for (int R = 0; R < kTileSubs; ++R) {
    float rp[2][NF];
#pragma unroll
    for (int q = 0; q < NF; ++q) rp[0][q] = rp[1][q] = 0.0f;
    bool ran = false;
#pragma unroll 1
    for (int C = diag ? R : 0; C < kTileSubs; ++C) {
      if (!((mask >> (kTileSubs * R + C)) & 1u)) continue;
      const int c = kTileSub * C + gam;
      int rows[2], base[2];
      float dx[2], dy[2], dz[2], inv_r2[2], x[2];
      bool valid[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        rows[p] = kTileSub * R + rho + 4 * p;
        valid[p] = pair_setup<NF, POLY>(st, rows[p], c, diag, cst, s_fit,
                                        s_map, n_species, stride, dx[p],
                                        dy[p], dz[p], inv_r2[p], x[p],
                                        base[p]);
      }
      if (!__any_sync(kFull, valid[0] || valid[1])) continue;
      ran = true;
      float A[2], B[2];
      clenshaw<2>(s_coef, deg, base, x, A, B);
      float ct[NF];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float row[NF], col[NF];
        pair_apply<NRHS, NF>(st, rows[p], c, valid[p], A[p], B[p], dx[p],
                             dy[p], dz[p], inv_r2[p], row, col);
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          rp[p][q] += row[q];
          ct[q] = p == 0 ? col[q] : ct[q] + col[q];
        }
      }
      // column 8C + γ over the sub-block's 8 rows: the lanes of one γ
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        ct[q] += __shfl_xor_sync(kFull, ct[q], 1);
        ct[q] += __shfl_xor_sync(kFull, ct[q], 2);
      }
      if (C == rho)
#pragma unroll
        for (int q = 0; q < NF; ++q) st.col[q][own_c] += ct[q];
    }
    if (!ran) continue;
    // rows 8R + ρ (+ 4) over their 32 columns: the lanes of one ρ
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        rp[p][q] += __shfl_xor_sync(kFull, rp[p][q], 4);
        rp[p][q] += __shfl_xor_sync(kFull, rp[p][q], 8);
        rp[p][q] += __shfl_xor_sync(kFull, rp[p][q], 16);
      }
    if ((gam >> 1) == R)
#pragma unroll
      for (int q = 0; q < NF; ++q)
        st.row[q][own_r] = (gam & 1) ? rp[1][q] : rp[0][q];
  }
  __syncwarp();  // the row and column sums are written

  // the pair's two partials, one writer an element (lane l: row l and
  // column l): the row side at a's slot of b, the column side at b's
  // slot of a (a diagonal pair's two sides added at its one slot), each
  // written only where its tile lies in the slice
  const int first = row_start[t0];
  float* out_r = part + (size_t)(row_start[a] - first + pr.z) * NRHS
                            * kTileRows * 3;
  float* out_c = part + (size_t)(row_start[b] - first + pr.w) * NRHS
                            * kTileRows * 3;
  if (diag) {
#pragma unroll
    for (int q = 0; q < NF; ++q)
      out_r[((q / 3) * kTileRows + lane) * 3 + q % 3] =
          st.row[q][lane] + st.col[q][lane];
  } else {
    if (a >= t0 && a < t0 + nt)
#pragma unroll
      for (int q = 0; q < NF; ++q)
        out_r[((q / 3) * kTileRows + lane) * 3 + q % 3] = st.row[q][lane];
    if (b >= t0 && b < t0 + nt)
#pragma unroll
      for (int q = 0; q < NF; ++q)
        out_c[((q / 3) * kTileRows + lane) * 3 + q % 3] = st.col[q][lane];
  }
}

// The second pass: out[k][i][d] for the nt·32 rows i of the slice, the
// partials of tile x = t0 + i/32's live slots summed in its list's order
// (partial row_start[x] − row_start[t0] + s for slot s).
__global__ void tile_sum_slots_kernel(const float* __restrict__ part,
                                      const int* __restrict__ row_start,
                                      int t0, int nt, int nrhs,
                                      float* __restrict__ out) {
  const size_t per_rhs = (size_t)nt * kTileRows * 3;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nrhs * per_rhs) return;
  const int k = (int)(e / per_rhs);
  const int rem = (int)(e % per_rhs);
  const int x = t0 + rem / (kTileRows * 3);
  const int within = rem % (kTileRows * 3);
  const int first = row_start[t0];
  float v = 0.0f;
  for (int g = row_start[x]; g < row_start[x + 1]; ++g)
    v += part[((size_t)(g - first) * nrhs + k) * kTileRows * 3 + within];
  out[e] = v;
}

struct TileArgs {
  const float* pos;
  const int* ids;
  const float* force;
  const int* species;
  const int* pairs;
  const int* n_pairs;
  int cap;
  const int* row_start;
  int n_pad;
  int t0;
  int nt;
  TileConsts cst;
  const float2* coef;
  const float* fit_consts;
  int n_fits;
  int deg;
  const int* pair_map;
  int n_species;
  float* part;
};

template <int NRHS, bool POLY>
int launch_tiles(int shared, cudaStream_t stream, const TileArgs& g) {
  auto kernel = ewald_tile_kernel<NRHS, POLY>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(g.cap + kTileWarps - 1) / kTileWarps, kTileWarps * 32, shared,
           stream>>>(g.pos, g.ids, g.force, g.species,
                     reinterpret_cast<const int4*>(g.pairs), g.n_pairs,
                     g.cap, g.row_start, g.n_pad, g.t0, g.nt, g.cst, g.coef,
                     g.fit_consts, g.n_fits, g.deg, g.pair_map, g.n_species,
                     g.part);
  return static_cast<int>(cudaGetLastError());
}

int launch_tile_sweep(int nrhs, bool poly, int shared, cudaStream_t stream,
                      const TileArgs& g) {
  if (nrhs == 1)
    return poly ? launch_tiles<1, true>(shared, stream, g)
                : launch_tiles<1, false>(shared, stream, g);
  return poly ? launch_tiles<2, true>(shared, stream, g)
              : launch_tiles<2, false>(shared, stream, g);
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
// ⌈n_cols/32⌉·nrhs·n_rows·3 floats (scratch, fully overwritten).
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
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
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

// K4 tiles' tile size and shared-table capacity (the wrapper checks its
// own against them).
int ewald_tile_rows() { return kTileRows; }
int ewald_tile_table_capacity() { return kTileTableBytes; }

// K4 tiles: out (nrhs, nt·32, 3), the pair terms of the row tiles
// [t0, t0 + nt) against their listed neighbor tiles (see the kernel's
// note).  pos (n_pad, 3), ids (n_pad,) int32, force (nrhs, n_pad, 3),
// species (n_pad,) int32 or NULL (monodisperse); pairs (≥ cap, 4) int32,
// the slice's unordered tile pairs (a, b ≥ a, slot of b in a's list, slot
// of a in b's list; tiles.tile_pairs / slice_pairs) with its used length
// at n_pairs on the device, at most cap, the slice's live list entries;
// row_start (t + 1,) int32 the prefix sum of the lists' live entries;
// consts: 7 host floats (box[3], inv_box[3], rc); coef (n_fits, deg+1, 4,
// 2) and fit_consts (n_fits, 8) floats, pair_map (S, S) int32 or NULL;
// part holds cap·nrhs·32·3 floats (scratch, one partial a live slot of
// the slice, all written).
int ewald_real_tiles(const float* pos, const int* ids, const float* force,
                     const int* species, const int* pairs,
                     const int* n_pairs, int cap, const int* row_start,
                     int n_pad, int t0, int nt, int nrhs,
                     const float* consts, const float* coef,
                     const float* fit_consts, int n_fits, int deg,
                     const int* pair_map, int n_species, float* part,
                     float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool poly = species != nullptr;
  if (n_fits < 1 || deg < 0 || cap < 0 || (poly && pair_map == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int shared = tile_table_bytes(n_fits, deg, poly ? n_species : 0);
  if (shared > kTileTableBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0) return 0;
  TileConsts cst;
  for (int d = 0; d < 3; ++d) {
    cst.box[d] = consts[d];
    cst.inv_box[d] = consts[3 + d];
  }
  cst.rc = consts[6];
  if (cap > 0) {
    const TileArgs g{pos, ids, force, species, pairs, n_pairs, cap,
                     row_start, n_pad, t0, nt, cst,
                     reinterpret_cast<const float2*>(coef), fit_consts,
                     n_fits, deg, pair_map, poly ? n_species : 0, part};
    const int code = launch_tile_sweep(nrhs, poly, shared, stream, g);
    if (code != 0) return code;
  }
  const size_t total = (size_t)nrhs * nt * kTileRows * 3;
  const int threads = 256;
  tile_sum_slots_kernel<<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, stream>>>(part, row_start, t0, nt, nrhs,
                                                out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
