// RPY + Swan–Brady wall pair sweeps for Hopper (sm_90a), float32.
//
// Two kernels replace the two Pallas TPU kernels on the fluctuating-BD main
// path (rigid_body_light_tpu/ops/rpy_pallas.py):
//
//   K1 pair_sweep_sym      replaces _kernel_sym (rpy_pallas.py:312): every
//                          unordered pair i<j once, applied forward
//                          (M_ij·F_j into row i) and transposed
//                          (M_ijᵀ·F_i into column j).  1 or 2 RHS sharing
//                          the pair fields.
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
// What bounds them on the card: arithmetic.  Each pair costs ~20 operations
// of free-space fields, ~50 more for the five wall fields, two rsqrt and
// one IEEE division (rpy_fields.cuh), then 19 per RHS and direction to
// apply them; the operands are 24-48 bytes per blob, so the sweep is O(N²)
// compute over O(N) data that lives in shared memory and registers.
//
// K1.  The earlier design ran a grid of 128-row tiles × 512-column chunks:
// at 10,272 blobs about half of its 81 × 21 blocks lay below the diagonal
// and only wrote zero partials, and the ~900 that worked all fitted on the
// card in one uneven wave, one pair a thread (0.589 ms, 6.2× the bound).
// Now the work is 128 × 128 items, tile pairs (I, J ≥ I) of the upper
// triangle, and a block walks the items of one unit of group pairs,
// diagonal units first (tile_items.cuh, as K4).  Up to 65,536 blobs a unit
// is one item (pair_sweep_sym_kernel: 3,321 blocks at 10,272 blobs);
// beyond, pair_sweep_sym_grouped_kernel walks the ~(T/128)² items of a
// unit with the same pieces (one kernel with the walk compiled out for
// G = T took 4% longer at the dense slice, PERF.md §6).  Thread t owns row 128·I + t
// and evaluates two pairs a step, columns c and c + 32 of the item, so it
// has two independent chains through the rsqrt and the division.  Lane l visits column (l + s) mod 32
// of each 32-column half at step s: the lanes of a warp touch distinct
// columns, so each warp adds its transposed terms into its own shared
// column accumulator without conflicts, and the 4 warps' accumulators are
// summed in a fixed order.  A unit keeps one row and one column partial a
// tile of its groups (one writer per element), so the scratch grows as n,
// not as the n²/128² items (2.63 GB at 409,600 blobs and 2 RHS, where one
// partial an item took 31.5 GB); a second pass sums them in a fixed order.
// 56 / 80 registers with a wall at 1 / 2 RHS (4 bytes spilled at 2 RHS),
// 12 / 22 KB of shared memory.  On an H100 at 700 W at 10,272 blobs:
// 0.325-0.331 / 0.433-0.442 ms at 1 / 2 RHS, 3.5× / 3.1× the bound,
// against the earlier design's 0.577-0.586 ms at 1 RHS in the same runs;
// one pair a thread took 3% / 3.5% longer (PERF.md §6).
//
// K2.  The earlier design ran ⌈n/32⌉ blocks of 256 threads, one row a
// thread, all columns a block: 321 blocks at 10,272 blobs on 132 SMs, so
// 57 SMs carried 3 blocks and 75 carried 2 (0.905 ms, 6.4× the bound).
// Now a block of 4 warps owns 64 rows (two a lane: lane and lane + 32) and
// a chunk of 256 columns, 64 a warp; every lane of a warp reads the same
// column (a shared-memory broadcast) and applies it to both of its rows.
// The columns are split into chunks because the rows alone give too few
// blocks (161 of 64 rows at the slice): 64 × 256 blocks make 6,601 at the
// slice, many waves of the ~1,000 that fit at once, so the launch ends
// within one short block of balance.  Each chunk writes its rows' partials
// (one writer per element), and a second pass sums the chunks in order.
// 56 / 72 registers with a wall, no spills, 11 / 18 KB of shared memory at
// 1 / 2 RHS.  On the same card: 0.537-0.546 ms at 2 RHS, 3.8× the bound,
// against the earlier design's 0.906-0.907 ms; four rows a lane took
// 0.6% longer.
// An ordered sweep evaluates every pair's fields twice, once from each
// side; its contract (rows × all columns, global offsets) serves the
// sharded slabs and mobility_apply_rows.
//
// Box forms (template BOX; rpy_pallas.py:369-373, :454-476 for K1, :214-218,
// :278-300 for K2).  With the pseudo-2D (Lx, Ly) box a pair's dx, dy are
// wrapped to the minimum image (rpy_fields::wrap: the float64 plain sweep's
// image on the same float32 inputs, ties at ±L/2 included), and with S ≥ 1
// shells the pair is evaluated again at each of the (2S+1)² − 1 nonzero
// offsets (ix·Lx, iy·Ly) of the wrapped displacement, in the JAX package's
// lattice order, its fields scaled by the ring's tail weight.  A pair sums
// its offsets' terms in registers first, then adds them through its select
// (K1: the whole pair; K2: the self pair's offset 0 only, so a blob keeps
// its own images and K2's image sum arrives complete).  K1 never visits
// i == i: rpy_cuda.pair_sum adds the self-image diagonal
// (rpy.self_image_sum).  The work is (2S+1)² times the pair work of the
// minimum image; the partials do not depend on S.  Free and box forms
// share one pair body: the wrap and the offset loop (offsets outer, a
// thread's two pairs or two rows inner) compile in only with BOX.  A body
// of their own for the box forms, or one with the pair outer, took 6-36%
// longer at S = 2 (PERF.md §6).  72 / 125 registers for K1 with a wall at
// 1 / 2 RHS, K2 64 / 80, no spills.  On an H100 at 700 W at the film
// slice (10,272 blobs): K1 at 1 RHS 0.430-0.441 / 6.41-6.44 ms at S = 0 /
// 2; K2 at 2 RHS 0.762-0.764 / 12.47 ms (PERF.md §6).
//
// POLY forms (template POLY; rpy_pallas.py:232-242 for K2, :384-397 for
// K1): per-blob radii in units of a (ahat), staged as the fourth component
// of a blob's float4 in place of its floored height, and the polydisperse
// fields rpy_fields::pair_fields_poly (Zuk et al.'s three branches; the
// wall terms at the pair's √(aᵢaⱼ), the heights floored per pair after the
// scaling).  K2's row and column radii come with its row and column
// slices.  The fields stay symmetric under i ↔ j, so K1's transposed apply
// holds.  The far branch costs 15 operations
// more than the monodisperse fields; the overlap and deep branches, with
// their two IEEE divisions, run on the few pairs closer than aᵢ + aⱼ.
// 56 / 80 registers for K1 with a wall at 1 / 2 RHS (4 bytes spilled at
// 2 RHS, as the monodisperse form), K2 56 / 64.  On an H100 at 700 W at
// the mixture slice (10,296 blobs): K1 0.381 / 0.496 ms at 1 / 2 RHS,
// +13% / +11% over its monodisperse form at the same positions; K2 0.520 /
// 0.628 ms, +18% / +15% (PERF.md §6).
//
// POLY × BOX forms (POLY and BOX together; rpy_pallas.py:592-640 with
// box_over_a and ahat): the box forms' wrap and offset loop around the
// POLY fields, the same pair body.  A pair's radii and raw heights do not
// change across its images, so the offset loop adds no per-blob values,
// only the POLY fields' per-pair ones.  K1 leaves out a blob's own images
// as in the box form; rpy_cuda.pair_sum adds them with the blob's radius
// (rpy.self_image_sum with ahat).  80 / 121 registers for K1 with a wall
// at 1 / 2 RHS (12 bytes spilled at 1 RHS, 28 in the grouped kernel), K2
// 80 / 96, no spills.  On an H100 at 700 W at the polydisperse film
// (10,296 blobs in a (10, 10) box): K1 at 1 RHS 0.522 / 8.26 ms at S = 0 /
// 2, +17% / +28% over its box form at the same positions; K2 at 2 RHS
// 0.945 / 16.35 ms, +22% / +30% (PERF.md §6).
//
// Per-blob quantities (the floored height, or a POLY form's radius) are
// computed once per blob, when the blob is loaded, and staged beside its
// position as a float4.
// Neither kernel uses atomics: launches are bitwise repeatable.
//
// Plain C interface for ctypes; every launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "rpy_fields.cuh"
#include "tile_items.cuh"

namespace {

using rpy_fields::Box;
using rpy_fields::Fields;
using rpy_fields::apply;
using rpy_fields::floor_height;
using rpy_fields::for_each_offset;
using rpy_fields::scale;
using rpy_fields::pair_fields;
using rpy_fields::pair_fields_poly;
using rpy_fields::wrap;

// K1: items of kSymTile × kSymTile, one row a thread, kSymPairs columns a
// step.
constexpr int kSymTile = tile_items::kTile;
constexpr int kSymSub = 32;
constexpr int kSymWarps = kSymTile / 32;
constexpr int kSymPairs = 2;

// K2: a block of kOrdWarps warps owns kOrdRows rows (kOrdRows / 32 a lane)
// and kOrdChunk columns (kOrdChunk / kOrdWarps a warp).
constexpr int kOrdWarps = 4;
constexpr int kOrdRows = 64;
constexpr int kOrdRowsPerLane = kOrdRows / 32;
constexpr int kOrdChunk = 256;
constexpr int kOrdWarpCols = kOrdChunk / kOrdWarps;

// Blob b of (n, 3) positions as (x, y, z, floored z); a blob past n is a
// finite stand-in at height 1 (its pairs are masked).
__device__ __forceinline__ float4 load_blob(const float* __restrict__ pos,
                                            int b, int n, float h_floor) {
  const bool ok = b < n;
  const float z = ok ? pos[3 * b + 2] : 1.0f;
  return make_float4(ok ? pos[3 * b] : 0.0f, ok ? pos[3 * b + 1] : 0.0f, z,
                     floor_height(z, h_floor));
}

// POLY forms: blob b as (x, y, z, radius in units of a); the heights are
// floored per pair (rpy_fields::pair_fields_poly).  Past n a finite
// stand-in at height 1 and radius 1 (its pairs are masked).
__device__ __forceinline__ float4 load_blob_poly(
    const float* __restrict__ pos, const float* __restrict__ ahat, int b,
    int n) {
  const bool ok = b < n;
  return make_float4(ok ? pos[3 * b] : 0.0f, ok ? pos[3 * b + 1] : 0.0f,
                     ok ? pos[3 * b + 2] : 1.0f, ok ? ahat[b] : 1.0f);
}

template <bool POLY>
__device__ __forceinline__ float4 stage_blob(const float* __restrict__ pos,
                                             const float* __restrict__ ahat,
                                             int b, int n, float h_floor) {
  if constexpr (POLY) return load_blob_poly(pos, ahat, b, n);
  else return load_blob(pos, b, n, h_floor);
}

// The fields of the pair (R, C) at displacement (dx, dy, dz): the
// monodisperse fields from the staged floored heights, or the POLY fields
// from the raw heights and radii.
template <bool WALL, bool POLY>
__device__ __forceinline__ Fields fields_at(float dx, float dy, float dz,
                                            const float4& R, const float4& C,
                                            float h_floor) {
  if constexpr (POLY)
    return pair_fields_poly<WALL>(dx, dy, dz, R.z, C.z, R.w, C.w, h_floor);
  else return pair_fields<WALL>(dx, dy, dz, R.w, C.w);
}

// F_k of blob b of (nrhs, n, 3) forces as (fx, fy, fz, 0); 0 past n.
__device__ __forceinline__ float4 load_force(const float* __restrict__ force,
                                             int k, int b, int n) {
  if (b >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* f = force + ((size_t)k * n + b) * 3;
  return make_float4(f[0], f[1], f[2], 0.0f);
}

// K1's pieces, shared by its two kernels.

// Stage column tile J: positions, forces and zeroed column accumulators.
template <int NRHS, bool POLY>
__device__ __forceinline__ void stage_columns(
    const float* __restrict__ pos, const float* __restrict__ force,
    const float* __restrict__ ahat, int J, int n, float h_floor, int t,
    float4 (&s_pos)[kSymTile], float4 (&s_f)[NRHS][kSymTile],
    float4 (&s_acc)[kSymWarps][NRHS][kSymTile]) {
  s_pos[t] = stage_blob<POLY>(pos, ahat, J * kSymTile + t, n, h_floor);
#pragma unroll
  for (int k = 0; k < NRHS; ++k) {
    s_f[k][t] = load_force(force, k, J * kSymTile + t, n);
#pragma unroll
    for (int w = 0; w < kSymWarps; ++w)
      s_acc[w][k][t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Row blob i: its position (returned) and forces; its sums zeroed.
template <int NRHS, bool POLY>
__device__ __forceinline__ float4 load_row(const float* __restrict__ pos,
                                           const float* __restrict__ force,
                                           const float* __restrict__ ahat,
                                           int i, int n, float h_floor,
                                           float (&fR)[3 * NRHS],
                                           float (&acc)[3 * NRHS]) {
  const float4 R = stage_blob<POLY>(pos, ahat, i, n, h_floor);
#pragma unroll
  for (int k = 0; k < NRHS; ++k) {
    const float4 f = load_force(force, k, i, n);
    fR[3 * k] = f.x; fR[3 * k + 1] = f.y; fR[3 * k + 2] = f.z;
  }
#pragma unroll
  for (int q = 0; q < 3 * NRHS; ++q) acc[q] = 0.0f;
  return R;
}

// A pair's forward terms M·F_C (u) and transposed terms Mᵀ·F_R (v) for
// each RHS, from its fields at in-plane displacement (dx, dy); ADD adds
// them to u and v (an image), else they are the pair's first terms.
template <bool WALL, int NRHS, bool ADD>
__device__ __forceinline__ void sym_terms(const Fields& f, float dx, float dy,
                                          float dz, const float4 (&fC)[NRHS],
                                          const float (&fR)[3 * NRHS],
                                          float (&u)[3 * NRHS],
                                          float (&v)[3 * NRHS]) {
#pragma unroll
  for (int k = 0; k < NRHS; ++k) {
    float ux, uy, uz, tx, ty, tz;
    apply<WALL, false>(f, dx, dy, dz, fC[k].x, fC[k].y, fC[k].z, ux, uy, uz);
    apply<WALL, true>(f, dx, dy, dz, fR[3 * k], fR[3 * k + 1], fR[3 * k + 2],
                      tx, ty, tz);
    if constexpr (ADD) {
      u[3 * k] += ux; u[3 * k + 1] += uy; u[3 * k + 2] += uz;
      v[3 * k] += tx; v[3 * k + 1] += ty; v[3 * k + 2] += tz;
    } else {
      u[3 * k] = ux; u[3 * k + 1] = uy; u[3 * k + 2] = uz;
      v[3 * k] = tx; v[3 * k + 1] = ty; v[3 * k + 2] = tz;
    }
  }
}

// One item's pairs: thread t's row (R, fR) against the staged columns,
// row terms into acc, transposed terms into its warp's column sums.
template <bool WALL, int NRHS, bool BOX, bool POLY>
__device__ __forceinline__ void sweep_item(
    const float4 (&s_pos)[kSymTile], const float4 (&s_f)[NRHS][kSymTile],
    float4 (&s_acc)[kSymWarps][NRHS][kSymTile], const float4 R,
    const float (&fR)[3 * NRHS], float (&acc)[3 * NRHS], bool diag,
    bool row_ok, int n_cols, int t, int lane, int warp, float h_floor,
    const Box& box) {
  constexpr int NF = 3 * NRHS;
  for (int q0 = 0; q0 < kSymTile; q0 += kSymPairs * kSymSub) {
    // diagonal item: this warp's rows are all right of these columns
    if (diag && q0 + kSymPairs * kSymSub <= warp * 32) continue;
    for (int s = 0; s < kSymSub; ++s) {
      int c[kSymPairs];
      bool valid[kSymPairs];
      bool any = false;
#pragma unroll
      for (int p = 0; p < kSymPairs; ++p) {
        c[p] = q0 + p * kSymSub + ((lane + s) & (kSymSub - 1));
        valid[p] = row_ok && c[p] < n_cols && (!diag || c[p] > t);
        any = any || valid[p];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      float dx0[kSymPairs], dy0[kSymPairs], dz[kSymPairs];
      float4 C[kSymPairs];
      float4 fC[kSymPairs][NRHS];
      float u[kSymPairs][NF], v[kSymPairs][NF];  // forward, transposed
#pragma unroll
      for (int p = 0; p < kSymPairs; ++p) {
        C[p] = s_pos[c[p]];
        dx0[p] = BOX ? wrap(R.x, C[p].x, box.lx, box.ilx) : R.x - C[p].x;
        dy0[p] = BOX ? wrap(R.y, C[p].y, box.ly, box.ily) : R.y - C[p].y;
        dz[p] = R.z - C[p].z;
#pragma unroll
        for (int k = 0; k < NRHS; ++k) fC[p][k] = s_f[k][c[p]];
        sym_terms<WALL, NRHS, false>(
            fields_at<WALL, POLY>(dx0[p], dy0[p], dz[p], R, C[p], h_floor),
            dx0[p], dy0[p], dz[p], fC[p], fR, u[p], v[p]);
      }
      if constexpr (BOX)
        for_each_offset(box, [&](float ix, float iy, float w) {
#pragma unroll
          for (int p = 0; p < kSymPairs; ++p) {
            const float dx = fmaf(ix, box.lx, dx0[p]);
            const float dy = fmaf(iy, box.ly, dy0[p]);
            Fields f = fields_at<WALL, POLY>(dx, dy, dz[p], R, C[p], h_floor);
            scale(f, w);
            sym_terms<WALL, NRHS, true>(f, dx, dy, dz[p], fC[p], fR, u[p],
                                        v[p]);
          }
        });
#pragma unroll
      for (int p = 0; p < kSymPairs; ++p) {
#pragma unroll
        for (int k = 0; k < NRHS; ++k) {
          acc[3 * k] += valid[p] ? u[p][3 * k] : 0.0f;
          acc[3 * k + 1] += valid[p] ? u[p][3 * k + 1] : 0.0f;
          acc[3 * k + 2] += valid[p] ? u[p][3 * k + 2] : 0.0f;
          float4 a = s_acc[warp][k][c[p]];
          a.x += valid[p] ? v[p][3 * k] : 0.0f;
          a.y += valid[p] ? v[p][3 * k + 1] : 0.0f;
          a.z += valid[p] ? v[p][3 * k + 2] : 0.0f;
          s_acc[warp][k][c[p]] = a;
        }
      }
      __syncwarp();  // lane l's columns are lane l − 1's at the next step
    }
  }
}

// Column t of RHS k: the warps' sums in a fixed order.
template <int NRHS>
__device__ __forceinline__ float4 column_sum(
    const float4 (&s_acc)[kSymWarps][NRHS][kSymTile], int k, int t) {
  float4 v = s_acc[0][k][t];
#pragma unroll
  for (int w = 1; w < kSymWarps; ++w) {
    const float4 a = s_acc[w][k][t];
    v.x += a.x; v.y += a.y; v.z += a.z;
  }
  return v;
}

// K1, one item (I, J) a block: the launch up to 65,536 blobs (G = T).
// Partials (items, 3·NRHS, 128), one slot per item.
template <bool WALL, int NRHS, bool BOX, bool POLY>
__global__ void __launch_bounds__(kSymTile)
pair_sweep_sym_kernel(const float* __restrict__ pos,     // (n, 3)
                      const float* __restrict__ force,   // (NRHS, n, 3)
                      const float* __restrict__ ahat,    // (n,), POLY only
                      int n, int n_tiles, float h_floor, Box box,
                      float* __restrict__ row_part,      // (items, 3·NRHS, 128)
                      float* __restrict__ col_part) {    // (items, 3·NRHS, 128)
  constexpr int NF = 3 * NRHS;
  __shared__ float4 s_pos[kSymTile];   // x, y, z, floored z (POLY: radius)
  __shared__ float4 s_f[NRHS][kSymTile];                 // fx, fy, fz, 0
  __shared__ float4 s_acc[kSymWarps][NRHS][kSymTile];    // transposed terms

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int I, J;
  tile_items::item_tiles(blockIdx.x, n_tiles, I, J);
  stage_columns<NRHS, POLY>(pos, force, ahat, J, n, h_floor, t, s_pos, s_f,
                            s_acc);
  const int i = I * kSymTile + t;
  float fR[NF];
  float acc[NF];
  const float4 R = load_row<NRHS, POLY>(pos, force, ahat, i, n, h_floor, fR,
                                        acc);
  __syncthreads();  // the stage is written

  sweep_item<WALL, NRHS, BOX, POLY>(s_pos, s_f, s_acc, R, fR, acc, I == J,
                                    i < n, min(kSymTile, n - J * kSymTile), t,
                                    lane, warp, h_floor, box);
  __syncthreads();  // every warp's column accumulator is complete

  // thread t: row t of tile I and column t of tile J
  float* rowp = row_part + (size_t)blockIdx.x * NF * kSymTile;
  float* colp = col_part + (size_t)blockIdx.x * NF * kSymTile;
#pragma unroll
  for (int k = 0; k < NRHS; ++k) {
    const float4 v = column_sum<NRHS>(s_acc, k, t);
    rowp[(3 * k) * kSymTile + t] = acc[3 * k];
    rowp[(3 * k + 1) * kSymTile + t] = acc[3 * k + 1];
    rowp[(3 * k + 2) * kSymTile + t] = acc[3 * k + 2];
    colp[(3 * k) * kSymTile + t] = v.x;
    colp[(3 * k + 1) * kSymTile + t] = v.y;
    colp[(3 * k + 2) * kSymTile + t] = v.z;
  }
}

// K1 past 65,536 blobs (G < T): a block walks the items (I, J) of its
// unit of group pairs row by row (tile_items.cuh).  Thread t carries row t
// of tile I through the row's items and writes its slot once; column t of
// tile J's slot is written at the unit's first row and added to after.
// Partials (units, S, 3·NRHS, 128).
template <bool WALL, int NRHS, bool BOX, bool POLY>
__global__ void __launch_bounds__(kSymTile)
pair_sweep_sym_grouped_kernel(const float* __restrict__ pos,     // (n, 3)
                              const float* __restrict__ force,   // (NRHS, n, 3)
                              const float* __restrict__ ahat,    // (n,), POLY
                              int n, tile_items::Groups g, float h_floor,
                              Box box, float* __restrict__ row_part,
                              float* __restrict__ col_part) {
  constexpr int NF = 3 * NRHS;
  __shared__ float4 s_pos[kSymTile];
  __shared__ float4 s_f[NRHS][kSymTile];
  __shared__ float4 s_acc[kSymWarps][NRHS][kSymTile];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const tile_items::Unit u = tile_items::unit_of(blockIdx.x, g);

  for (int I = u.I0; I < u.I1; ++I) {
    const int i = I * kSymTile + t;
    float fR[NF];
    float acc[NF];
    const float4 R = load_row<NRHS, POLY>(pos, force, ahat, i, n, h_floor,
                                          fR, acc);
    for (int J = u.first_col(I); J < u.J1; ++J) {
      __syncthreads();  // the previous item's stage and sums are read
      stage_columns<NRHS, POLY>(pos, force, ahat, J, n, h_floor, t, s_pos,
                                s_f, s_acc);
      __syncthreads();  // the stage is written
      sweep_item<WALL, NRHS, BOX, POLY>(s_pos, s_f, s_acc, R, fR, acc,
                                        I == J, i < n,
                                        min(kSymTile, n - J * kSymTile), t,
                                        lane, warp, h_floor, box);
      __syncthreads();  // every warp's column accumulator is complete
      float* colp = tile_items::slot(col_part, blockIdx.x, J - u.J0, g, NF);
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float4 v = column_sum<NRHS>(s_acc, k, t);
        float* cq = colp + (3 * k) * kSymTile + t;
        tile_items::store_col(cq, v.x, I == u.I0);
        tile_items::store_col(cq + kSymTile, v.y, I == u.I0);
        tile_items::store_col(cq + 2 * kSymTile, v.z, I == u.I0);
      }
    }
    float* rowp = tile_items::slot(row_part, blockIdx.x, I - u.I0, g, NF);
#pragma unroll
    for (int q = 0; q < NF; ++q) rowp[q * kSymTile + t] = acc[q];
  }
}

// K2.  Block (row block blockIdx.x, column chunk blockIdx.y), 4 warps:
// lane l owns rows l and l + 32 of the row block, warp w sweeps columns
// [64w, 64w + 64) of the chunk.  A pair is live iff its global ids differ
// and the column is in range; the 4 warps' sums are added in a fixed order
// into the chunk's partial.  Box form: the self pair is masked at offset 0
// only.
template <bool WALL, int NRHS, bool BOX, bool POLY>
__global__ void __launch_bounds__(kOrdWarps * 32)
pair_sweep_ordered_kernel(const float* __restrict__ rows_pos,   // (n_rows, 3)
                          const float* __restrict__ rows_ahat,  // (n_rows,), POLY
                          int n_rows, int row_offset,
                          const float* __restrict__ cols_pos,   // (n_cols, 3)
                          const float* __restrict__ cols_ahat,  // (n_cols,), POLY
                          const float* __restrict__ cols_force, // (NRHS, n_cols, 3)
                          int n_cols, int col_offset, float h_floor, Box box,
                          float* __restrict__ part) {  // (chunks, NRHS, n_rows, 3)
  constexpr int NF = 3 * NRHS;
  constexpr int RL = kOrdRowsPerLane;
  __shared__ float4 s_pos[kOrdChunk];
  __shared__ float4 s_f[NRHS][kOrdChunk];
  __shared__ float s_red[kOrdWarps][NF][kOrdRows];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int c0 = blockIdx.y * kOrdChunk;
  const int n_c = min(kOrdChunk, n_cols - c0);

  for (int c = t; c < kOrdChunk; c += kOrdWarps * 32) {
    s_pos[c] = stage_blob<POLY>(cols_pos, cols_ahat, c0 + c, n_cols,
                                h_floor);
#pragma unroll
    for (int k = 0; k < NRHS; ++k)
      s_f[k][c] = load_force(cols_force, k, c0 + c, n_cols);
  }
  float4 R[RL];
  bool row_ok[RL];
  int gi[RL];
  float acc[RL][NF];
#pragma unroll
  for (int r = 0; r < RL; ++r) {
    const int i = blockIdx.x * kOrdRows + r * 32 + lane;
    row_ok[r] = i < n_rows;
    gi[r] = row_offset + i;
    R[r] = stage_blob<POLY>(rows_pos, rows_ahat, i, n_rows, h_floor);
#pragma unroll
    for (int q = 0; q < NF; ++q) acc[r][q] = 0.0f;
  }
  __syncthreads();  // the stage is written

  const int c_end = min(n_c, (w + 1) * kOrdWarpCols);
  for (int c = w * kOrdWarpCols; c < c_end; ++c) {
    const float4 C = s_pos[c];
    const int gj = col_offset + c0 + c;
    float4 fC[NRHS];
#pragma unroll
    for (int k = 0; k < NRHS; ++k) fC[k] = s_f[k][c];
    float dx0[RL], dy0[RL], dz[RL];
    float u[RL][NF];  // the pairs' terms
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      dx0[r] = BOX ? wrap(R[r].x, C.x, box.lx, box.ilx) : R[r].x - C.x;
      dy0[r] = BOX ? wrap(R[r].y, C.y, box.ly, box.ily) : R[r].y - C.y;
      dz[r] = R[r].z - C.z;
      const Fields f = fields_at<WALL, POLY>(dx0[r], dy0[r], dz[r], R[r], C,
                                             h_floor);
#pragma unroll
      for (int k = 0; k < NRHS; ++k)
        apply<WALL, false>(f, dx0[r], dy0[r], dz[r], fC[k].x, fC[k].y,
                           fC[k].z, u[r][3 * k], u[r][3 * k + 1],
                           u[r][3 * k + 2]);
      if constexpr (BOX) {
        // the self pair is masked at offset 0 only: a blob keeps its images
#pragma unroll
        for (int q = 0; q < NF; ++q) u[r][q] = gi[r] != gj ? u[r][q] : 0.0f;
      }
    }
    if constexpr (BOX)
      for_each_offset(box, [&](float ix, float iy, float w) {
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const float dx = fmaf(ix, box.lx, dx0[r]);
          const float dy = fmaf(iy, box.ly, dy0[r]);
          Fields f = fields_at<WALL, POLY>(dx, dy, dz[r], R[r], C, h_floor);
          scale(f, w);
#pragma unroll
          for (int k = 0; k < NRHS; ++k) {
            float ux, uy, uz;
            apply<WALL, false>(f, dx, dy, dz[r], fC[k].x, fC[k].y, fC[k].z,
                               ux, uy, uz);
            u[r][3 * k] += ux;
            u[r][3 * k + 1] += uy;
            u[r][3 * k + 2] += uz;
          }
        }
      });
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const bool valid = row_ok[r] && (BOX || gi[r] != gj);
#pragma unroll
      for (int q = 0; q < NF; ++q) acc[r][q] += valid ? u[r][q] : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int q = 0; q < NF; ++q) s_red[w][q][r * 32 + lane] = acc[r][q];
  __syncthreads();
  for (int idx = t; idx < NF * kOrdRows; idx += kOrdWarps * 32) {
    const int q = idx / kOrdRows;
    const int rr = idx % kOrdRows;
    const int i = blockIdx.x * kOrdRows + rr;
    if (i >= n_rows) continue;
    float v = s_red[0][q][rr];
#pragma unroll
    for (int s = 1; s < kOrdWarps; ++s) v += s_red[s][q][rr];
    part[(((size_t)blockIdx.y * NRHS + q / 3) * n_rows + i) * 3 + q % 3] = v;
  }
}

// K2 second pass: out[e] = Σ_chunk part[chunk][e] in chunk order, for the
// per_chunk = nrhs·n_rows·3 elements e.
__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  int n_chunks, int per_chunk,
                                  float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_chunk) return;
  float v = 0.0f;
  for (int c = 0; c < n_chunks; ++c) v += part[(size_t)c * per_chunk + e];
  out[e] = v;
}

template <bool WALL, int NRHS, bool BOX, bool POLY>
void launch_sym_k(const tile_items::Groups& g, cudaStream_t stream,
                  const float* pos, const float* force, const float* ahat,
                  int n, float h_floor, const Box& box, float* row_part,
                  float* col_part) {
  if (g.n_groups < g.n_tiles)
    pair_sweep_sym_grouped_kernel<WALL, NRHS, BOX, POLY>
        <<<g.units, kSymTile, 0, stream>>>(pos, force, ahat, n, g, h_floor,
                                           box, row_part, col_part);
  else
    pair_sweep_sym_kernel<WALL, NRHS, BOX, POLY>
        <<<g.units, kSymTile, 0, stream>>>(pos, force, ahat, n, g.n_tiles,
                                           h_floor, box, row_part, col_part);
}

template <bool WALL, bool BOX, bool POLY>
void launch_sym(int nrhs, const tile_items::Groups& g, cudaStream_t stream,
                const float* pos, const float* force, const float* ahat,
                int n, float h_floor, const Box& box, float* row_part,
                float* col_part) {
  if (nrhs == 1)
    launch_sym_k<WALL, 1, BOX, POLY>(g, stream, pos, force, ahat, n, h_floor,
                                     box, row_part, col_part);
  else
    launch_sym_k<WALL, 2, BOX, POLY>(g, stream, pos, force, ahat, n, h_floor,
                                     box, row_part, col_part);
}

template <bool WALL, bool BOX, bool POLY>
void launch_ordered(int nrhs, dim3 grid, cudaStream_t stream,
                    const float* rows_pos, const float* rows_ahat, int n_rows,
                    int row_offset, const float* cols_pos,
                    const float* cols_ahat, const float* cols_force,
                    int n_cols, int col_offset, float h_floor,
                    const Box& box, float* part) {
  if (nrhs == 1)
    pair_sweep_ordered_kernel<WALL, 1, BOX, POLY>
        <<<grid, kOrdWarps * 32, 0, stream>>>(
            rows_pos, rows_ahat, n_rows, row_offset, cols_pos, cols_ahat,
            cols_force, n_cols, col_offset, h_floor, box, part);
  else
    pair_sweep_ordered_kernel<WALL, 2, BOX, POLY>
        <<<grid, kOrdWarps * 32, 0, stream>>>(
            rows_pos, rows_ahat, n_rows, row_offset, cols_pos, cols_ahat,
            cols_force, n_cols, col_offset, h_floor, box, part);
}

// The box of the C interface: none when box_x ≤ 0; the tail weights are
// 1 + α and 1 + β.
Box make_box(float box_x, float box_y, int shells, float alpha, float beta) {
  Box b;
  b.lx = box_x;
  b.ly = box_y;
  b.ilx = box_x > 0.0f ? 1.0f / box_x : 0.0f;
  b.ily = box_y > 0.0f ? 1.0f / box_y : 0.0f;
  b.shells = box_x > 0.0f ? shells : 0;
  b.w_outer = 1.0f + alpha;
  b.w_inner = 1.0f + beta;
  return b;
}

}  // namespace

extern "C" {

// The shapes the wrapper sizes its scratch by: K1's item edge and most
// groups, K2's rows and columns a block.
int rpy_sym_tile() { return kSymTile; }
int rpy_sym_max_groups() { return tile_items::kMaxGroups; }
int rpy_ordered_rows() { return kOrdRows; }
int rpy_ordered_chunk() { return kOrdChunk; }

// K1: out (nrhs, n, 3) = Σ_{j≠i} M_ij F_j over unordered pairs.  row_part
// and col_part hold units·S·3·nrhs·128 floats each (tile_items::groups_of;
// scratch, fully overwritten).
// With box_x > 0 the box form: the (box_x, box_y) box in units of a,
// ``shells`` image shells with tail coefficients (alpha, beta); K1 leaves
// out the self images (rpy.self_image_sum, with the radii in the POLY
// form).  With ahat (n radii in units of a; NULL for one radius) the POLY
// form, with or without the box.
int rpy_pair_sweep_sym(const float* pos, const float* force,
                       const float* ahat, int n, int nrhs, int wall,
                       float h_floor, float box_x, float box_y, int shells,
                       float alpha, float beta, float* row_part,
                       float* col_part, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (shells < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool boxed = box_x > 0.0f;
  if (n <= 0) return 0;
  const tile_items::Groups g = tile_items::groups_of(n);
  const Box box = make_box(box_x, box_y, shells, alpha, beta);
  if (ahat != nullptr && wall && boxed)
    launch_sym<true, true, true>(nrhs, g, stream, pos, force, ahat, n,
                                 h_floor, box, row_part, col_part);
  else if (ahat != nullptr && boxed)
    launch_sym<false, true, true>(nrhs, g, stream, pos, force, ahat, n,
                                  h_floor, box, row_part, col_part);
  else if (ahat != nullptr && wall)
    launch_sym<true, false, true>(nrhs, g, stream, pos, force, ahat, n,
                                  h_floor, box, row_part, col_part);
  else if (ahat != nullptr)
    launch_sym<false, false, true>(nrhs, g, stream, pos, force, ahat, n,
                                   h_floor, box, row_part, col_part);
  else if (wall && boxed)
    launch_sym<true, true, false>(nrhs, g, stream, pos, force, ahat, n,
                                  h_floor, box, row_part, col_part);
  else if (wall)
    launch_sym<true, false, false>(nrhs, g, stream, pos, force, ahat, n,
                                   h_floor, box, row_part, col_part);
  else if (boxed)
    launch_sym<false, true, false>(nrhs, g, stream, pos, force, ahat, n,
                                   h_floor, box, row_part, col_part);
  else
    launch_sym<false, false, false>(nrhs, g, stream, pos, force, ahat, n,
                                    h_floor, box, row_part, col_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      tile_items::sum_items(row_part, col_part, n, nrhs, out, stream));
}

// K2: out (nrhs, n_rows, 3) = Σ_j M_ij F_j over all columns j whose global
// id (col_offset + j) differs from the row's (row_offset + i).  part holds
// ⌈n_cols/256⌉·nrhs·n_rows·3 floats (scratch, fully overwritten).  The box
// arguments as K1's; the self pair keeps its images.  rows_ahat and
// cols_ahat (radii in units of a of the rows and of the columns, both or
// neither NULL) select the POLY form, with or without the box.
int rpy_pair_sweep_ordered(const float* rows_pos, const float* rows_ahat,
                           int n_rows, int row_offset, const float* cols_pos,
                           const float* cols_ahat, const float* cols_force,
                           int n_cols, int col_offset, int nrhs, int wall,
                           float h_floor, float box_x, float box_y,
                           int shells, float alpha, float beta, float* part,
                           float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (shells < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool poly = rows_ahat != nullptr;
  const bool boxed = box_x > 0.0f;
  if (poly != (cols_ahat != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const int n_chunks = n_cols > 0 ? (n_cols + kOrdChunk - 1) / kOrdChunk : 0;
  if (n_chunks > 0) {
    const dim3 grid((n_rows + kOrdRows - 1) / kOrdRows, n_chunks);
    const Box box = make_box(box_x, box_y, shells, alpha, beta);
#define RPY_ORDERED(W, B, P)                                                \
  launch_ordered<W, B, P>(nrhs, grid, stream, rows_pos, rows_ahat, n_rows,  \
                          row_offset, cols_pos, cols_ahat, cols_force,      \
                          n_cols, col_offset, h_floor, box, part)
    if (poly && wall && boxed)
      RPY_ORDERED(true, true, true);
    else if (poly && boxed)
      RPY_ORDERED(false, true, true);
    else if (poly && wall)
      RPY_ORDERED(true, false, true);
    else if (poly)
      RPY_ORDERED(false, false, true);
    else if (wall && boxed)
      RPY_ORDERED(true, true, false);
    else if (wall)
      RPY_ORDERED(true, false, false);
    else if (boxed)
      RPY_ORDERED(false, true, false);
    else
      RPY_ORDERED(false, false, false);
#undef RPY_ORDERED
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_chunk = nrhs * n_rows * 3;
  const int threads = 256;
  sum_chunks_kernel<<<(per_chunk + threads - 1) / threads, threads, 0,
                      stream>>>(part, n_chunks, per_chunk, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
