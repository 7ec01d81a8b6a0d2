// K3: the proxy-grid far field's exact near part for Hopper (sm_90a),
// float32.  Replaces the Pallas TPU kernel _kernel_nbr
// (rigid_body_light_tpu/ops/rpy_pallas.py:908, launched by
// _near_sweep_call at :1067, entry near_sweep at :1094).
//
// The blobs arrive sorted in cell-snake order and padded to t tiles of 128
// (rigid_body_light_tpu_torch/ops/farfield.py: prepare).  Tile a's
// neighbor list nbr[a] (t, max_nbr) holds its adjacent tiles in ascending
// order, −1 = empty slot.  A pair (i, j) is kept iff
//   - the cell offset of i and j is at most 1 on every axis,
//   - both are real blobs (live), and
//   - i ≠ j (sorted indices),
// which is the near/far partition the far tier's kernel lattices exclude,
// so every pair is counted exactly once.  out (k, t·128, 3) holds the pair
// terms Σ_j M_ij·F_j in sorted order: no self term, no 1/(8πηa), no
// damping (the caller, farfield.mobility_apply, adds them).  Rows of pad
// blobs hold finite garbage that the caller drops.
//
// What bounds it on the card: arithmetic.  The same RPY + Swan–Brady pair
// fields as K1/K2 (rpy_fields.cuh): ~60 flops, two rsqrt and one IEEE
// division per pair with a wall, then ~30 flops per RHS and direction.
// Its operands are ~60 bytes per blob, a few MB at 10⁵ blobs.
//
// Design: a symmetric sweep over unordered tile pairs.  The earlier design
// swept every row tile against each of its neighbor tiles, so it evaluated
// every kept pair's fields twice, once from each side: 42.1 GFLOP of work
// at 1 RHS against the 28.1 that the function needs (102,480 blobs, grid
// (12, 12, 3)), and its 48 KB stage at 2 RHS held an SM to 4 blocks.  It
// took 3.42-3.45 / 4.22-4.27 ms, 8.2× / 6.7× the bound (PERF.md).  Now:
//   - The work list (tiles.tile_pairs, built once per positions on the
//     device) holds each unordered adjacent tile pair (a, b), b ≥ a, once,
//     in list order, with the slot of b in a's list and of a in b's list.
//     The neighbor relation is symmetric (cell-range gaps), so that covers
//     every kept pair once.
//   - One block of 128 threads per tile pair: thread r owns row r of tile
//     a, tile b's 128 columns are staged in shared memory.  Each kept
//     pair's fields are evaluated once and applied twice: M_ij·F_j into row
//     i (registers) and M_ijᵀ·F_i = M_ji·F_i into column j.  For the column
//     side, lane l visits column (l + s) mod 32 of a 32-column sub-tile at
//     step s (K1's rotation, rpy_pair_sweep.cu): the lanes of a warp touch
//     distinct columns, so each warp adds into its own shared column
//     accumulator, and the 4 warps' accumulators are summed in a fixed
//     order.  On the diagonal pair (a, a) only r < c is kept, and a warp
//     skips the sub-tiles left of its rows.
//   - A step where no lane of the warp keeps its pair (a vote) is skipped;
//     a masked pair inside a kept step adds an exact 0 through a select on
//     the live flags of both sides (pad rows sit at a real blob's position,
//     so r² of a pad row against its twin is at the 1e-24 floor: a zero
//     force is not what keeps it out).
//   - The row side goes to partial slot [slot of b in a] of tile a, the
//     column side to slot [slot of a in b] of tile b (a diagonal pair adds
//     both sides of its tile in the block and writes once): every element
//     of the partials has exactly one writer.  A second pass sums each
//     tile's used slots in list order.  No atomics: launches repeat
//     bitwise.
//   - The grid is persistent: as many blocks as fit on the card at once,
//     block g taking items g, g + G, g + 2G, ... of the list, whose length
//     the kernel reads from the device (the list is built without a host
//     sync, so the host does not know it).
//   - Dead columns (pad blobs) are staged with a cell index far outside the
//     grid, so the adjacency test drops them, and with height 1 and zero
//     force, so their fields stay finite.  The cell test is on int32
//     indices, exact.
// Resources (ptxas, sm_90a): 56 / 62 registers with a wall at 1 / 2 RHS
// (48 / 48 without), no spills; 11 / 18.5 KB of static shared memory, so
// an SM holds 9 / 8 blocks of 4 warps (the earlier design: 36 / 48 KB).
// On an H100 at 700 W, at the far-field slice, 2.12-2.14 / 2.81-2.83 ms,
// 5.1× / 4.5× the bound (PERF.md §6).
//
// Box form (template BOX; the pseudo-2D film, rpy_pallas.py:960-963): the
// blobs arrive wrapped into the (Lx, Ly) box and the neighbor lists are
// cyclic in x/y (farfield._near_neighbor_lists with wrap_xy).  Compiled in
// only under BOX:
//   - dx and dy wrapped to the minimum image by rpy_fields::wrap, the rule
//     of K1's and K2's box forms and of the plain sweep
//     (rpy.wrapped_difference), so all of them take one image per pair.
//     It is odd in (xi, xj), ties included, which the symmetric design
//     needs: M_ijᵀ·F_i into column j is M_ji·F_i only if the column side's
//     displacement is the negated row side's;
//   - the x/y cell offsets wrapped cyclically by (gx, gy) before the ≤ 1
//     test, on integers, exact (dead columns keep their far z cell, which
//     is never wrapped, so they stay out);
//   - the wall image terms on the wrapped dx, dy (pair_fields takes them).
// No image lattice here: the image shells enter through the far tier
// only.  A tile the wrapped lists make adjacent to itself through a seam
// is still swept once, as its diagonal item, and a tile pair adjacent both
// directly and across a seam is listed once; the per-pair cyclic test then
// keeps each blob pair once.
//
// POLY form (template POLY; per-blob radii, rpy_pallas.py:977-988, which
// takes poly and box together, so POLY combines with BOX): the radii in
// units of a arrive sorted beside the positions (farfield.prepare's ah_s,
// dead blobs at 1).  Compiled in only under POLY:
//   - the tile's radii are staged in the shared slot that holds the
//     floored heights in the monodisperse form, and the heights stay raw:
//     the POLY wall fields floor z/√(aᵢaⱼ), a per-pair quantity;
//   - the pair fields are rpy_fields::pair_fields_poly, which K1's and
//     K2's POLY forms share (Zuk et al.'s far, overlap and deep branches;
//     the wall terms in units of √(aᵢaⱼ)), so the three cannot drift
//     apart.  They are symmetric under i ↔ j except ĥ, as the monodisperse
//     fields, so apply<WALL, true> still gives M_ji·F_i for the column side.
// Dead columns sit at radius 1 and height 1, so their fields stay finite
// (a 0 radius would divide by zero before the select).  Registers with a
// wall at 1 / 2 RHS: 56 / 56 (open), 55 / 56 (box), no spills, the same
// shared memory.  On an H100 at 700 W, at the far-field mixture (108,960
// blobs), 3.11 / 3.96 ms, +10% / +6% over the mono form at the same
// positions, 4.8× / 4.3× its bound (PERF.md §6).
//
// Row-tile slice (near_sweep's t0 / nt; the Pallas kernel's t0 / nt
// arguments, rpy_pallas.py:1094-1108, which the distributed far field
// gives each device, farfield.py:1672-1676): the output rows of tiles
// [t0, t0 + nt) alone.  The work list is the full list's unordered pairs
// with at least one tile in the slice, in list order
// (tiles.slice_pairs, built on the device).  The kernel is the same
// kernel: a pair's fields are evaluated once, and a side is written only
// where its tile lies in the slice, into partials and an output indexed
// from the slice's first row.  One writer per slot, no atomics, launches
// repeat bitwise.  A pair with one tile on each side of the slice's edge
// is evaluated by both slices that hold one of its tiles; each applies
// both sides and drops the other slice's.  A block-uniform guard around
// the two applies would skip that side, but it measured the whole sweep,
// the slice (0, t), 4-5% slower on an H100 (PERF.md §6).
//
// Plain C interface for ctypes; the launches go on the caller's stream,
// allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>

#include "rpy_fields.cuh"

namespace {

using rpy_fields::Fields;
using rpy_fields::apply;
using rpy_fields::floor_height;
using rpy_fields::pair_fields;
using rpy_fields::pair_fields_poly;
using rpy_fields::wrap;

constexpr int kTile = 128;             // blobs per tile (farfield.TILE)
constexpr int kSub = 32;               // columns per rotation sub-tile
constexpr int kWarps = kTile / 32;     // one row per thread
constexpr int kDeadCell = -(1 << 20);  // cell index of dead columns
constexpr int kMaxDevices = 64;

// The film's box for the box form: lengths in units of a, their
// reciprocals, and the cell counts of the cyclic axes.
struct CellBox {
  float lx, ly, ilx, ily;
  int gx, gy;
};

// Cyclic |cell offset| on an axis of g cells, for offsets in (−g, g).
__device__ __forceinline__ int cyclic_gap(int d, int g) {
  const int a = abs(d);
  return min(a, g - a);
}

// A blob's per-blob quantity beside its position: the floored height
// (monodisperse fields) or the radius in units of a (POLY).
template <bool POLY>
__device__ __forceinline__ float blob_aux(const float* __restrict__ ahat,
                                          int j, bool ok, float z,
                                          float h_floor) {
  if constexpr (POLY) return ok ? ahat[j] : 1.0f;
  return floor_height(z, h_floor);
}

// One block per tile pair (persistent).  pairs (cap, 4): a, b ≥ a, slot of
// b in a's list, slot of a in b's list; the first *n_pairs used.
// part (max_nbr, NRHS, nt·128, 3): per-slot partial sums of the rows of
// tiles [t0, t0 + nt); a side of a pair outside that range is not
// written.
template <bool WALL, int NRHS, bool BOX, bool POLY>
__global__ void __launch_bounds__(kTile)
near_pair_kernel(const float* __restrict__ pos,           // (n_pad, 3)
                 const int* __restrict__ cell,            // (n_pad, 3)
                 const unsigned char* __restrict__ live,  // (n_pad,)
                 const float* __restrict__ force,         // (NRHS, n_pad, 3)
                 const float* __restrict__ ahat,          // (n_pad,), POLY
                 const int4* __restrict__ pairs,
                 const int* __restrict__ n_pairs,
                 int n_pad, int t0, int nt, float h_floor, CellBox box,
                 float* __restrict__ part) {
  constexpr int NF = 3 * NRHS;
  const int n_out = nt * kTile;
  __shared__ float s_pos[3][kTile];
  __shared__ float s_aux[kTile];  // floored heights (POLY: radii)
  __shared__ int s_cell[3][kTile];
  __shared__ float s_f[NF][kTile];
  __shared__ float s_acc[kWarps][NF][kTile];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int count = *n_pairs;

  for (int item = blockIdx.x; item < count; item += gridDim.x) {
    const int4 pr = pairs[item];
    const int a = pr.x, b = pr.y;
    const bool diag = a == b;

    __syncthreads();  // the previous item's shared reads are done
    {
      const int j = b * kTile + t;
      const bool ok = live[j] != 0;
      s_pos[0][t] = ok ? pos[3 * j] : 0.0f;
      s_pos[1][t] = ok ? pos[3 * j + 1] : 0.0f;
      s_pos[2][t] = ok ? pos[3 * j + 2] : 1.0f;
      s_aux[t] = blob_aux<POLY>(ahat, j, ok, s_pos[2][t], h_floor);
      s_cell[0][t] = ok ? cell[3 * j] : kDeadCell;
      s_cell[1][t] = ok ? cell[3 * j + 1] : kDeadCell;
      s_cell[2][t] = ok ? cell[3 * j + 2] : kDeadCell;
#pragma unroll
      for (int k = 0; k < NRHS; ++k) {
        const float* fk = force + ((size_t)k * n_pad + j) * 3;
#pragma unroll
        for (int d = 0; d < 3; ++d) s_f[3 * k + d][t] = ok ? fk[d] : 0.0f;
      }
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int q = 0; q < NF; ++q) s_acc[w][q][t] = 0.0f;

    const int i = a * kTile + t;
    const bool row_live = live[i] != 0;
    const float xR = pos[3 * i];
    const float yR = pos[3 * i + 1];
    const float zR = row_live ? pos[3 * i + 2] : 1.0f;
    const float auxR = blob_aux<POLY>(ahat, i, row_live, zR, h_floor);
    const int cxR = cell[3 * i];
    const int cyR = cell[3 * i + 1];
    const int czR = cell[3 * i + 2];
    float fR[NF];
    float acc[NF];
#pragma unroll
    for (int k = 0; k < NRHS; ++k)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        fR[3 * k + d] = row_live ? force[((size_t)k * n_pad + i) * 3 + d]
                                 : 0.0f;
        acc[3 * k + d] = 0.0f;
      }
    __syncthreads();  // the stage is written

    for (int q0 = 0; q0 < kTile; q0 += kSub) {
      // diagonal pair: this warp's rows are all right of these columns
      if (diag && q0 < warp * 32) continue;
      for (int s = 0; s < kSub; ++s) {
        const int c = q0 + ((lane + s) & (kSub - 1));
        int dcx = cxR - s_cell[0][c];
        int dcy = cyR - s_cell[1][c];
        if constexpr (BOX) {
          dcx = cyclic_gap(dcx, box.gx);
          dcy = cyclic_gap(dcy, box.gy);
        }
        const bool keep = row_live && abs(dcx) <= 1 && abs(dcy) <= 1
                          && abs(czR - s_cell[2][c]) <= 1
                          && (!diag || t < c);
        if (!__any_sync(0xffffffffu, keep)) continue;
        const float dx = BOX ? wrap(xR, s_pos[0][c], box.lx, box.ilx)
                             : xR - s_pos[0][c];
        const float dy = BOX ? wrap(yR, s_pos[1][c], box.ly, box.ily)
                             : yR - s_pos[1][c];
        const float dz = zR - s_pos[2][c];
        Fields p;
        if constexpr (POLY)
          p = pair_fields_poly<WALL>(dx, dy, dz, zR, s_pos[2][c], auxR,
                                     s_aux[c], h_floor);
        else
          p = pair_fields<WALL>(dx, dy, dz, auxR, s_aux[c]);
#pragma unroll
        for (int k = 0; k < NRHS; ++k) {
          float ux, uy, uz, tx, ty, tz;
          apply<WALL, false>(p, dx, dy, dz, s_f[3 * k][c], s_f[3 * k + 1][c],
                             s_f[3 * k + 2][c], ux, uy, uz);
          apply<WALL, true>(p, dx, dy, dz, fR[3 * k], fR[3 * k + 1],
                            fR[3 * k + 2], tx, ty, tz);
          acc[3 * k] += keep ? ux : 0.0f;
          acc[3 * k + 1] += keep ? uy : 0.0f;
          acc[3 * k + 2] += keep ? uz : 0.0f;
          s_acc[warp][3 * k][c] += keep ? tx : 0.0f;
          s_acc[warp][3 * k + 1][c] += keep ? ty : 0.0f;
          s_acc[warp][3 * k + 2][c] += keep ? tz : 0.0f;
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every warp's column accumulator is complete

    // thread t: row t of tile a and column t of tile b, each written only
    // where its tile lies in the slice
    const bool a_in = a >= t0 && a < t0 + nt;
    const bool b_in = b >= t0 && b < t0 + nt;
    const int ra = a_in ? a - t0 : 0;  // the tiles' places in the slice
    const int rb = b_in ? b - t0 : 0;
    float* row_out =
        part + (((size_t)pr.z * NRHS) * n_out + ra * kTile + t) * 3;
    float* col_out =
        part + (((size_t)pr.w * NRHS) * n_out + rb * kTile + t) * 3;
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      float col = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) col += s_acc[w][q][t];
      const size_t off = (size_t)(q / 3) * n_out * 3 + q % 3;
      if (diag) {
        row_out[off] = acc[q] + col;
      } else {
        if (a_in) row_out[off] = acc[q];
        if (b_in) col_out[off] = col;
      }
    }
  }
}

// Second pass: out[k][i][d] = Σ over the used slots s of the tile of row
// i (the slice's i-th row, of tile t0 + i / 128), in list order, of
// part[s][k][i][d].
__global__ void sum_slots_kernel(const float* __restrict__ part,
                                 const int* __restrict__ nbr, int t0,
                                 int n_out, int max_nbr, int nrhs,
                                 float* __restrict__ out) {  // (nrhs, n_out, 3)
  const size_t per_rhs = (size_t)n_out * 3;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nrhs * per_rhs) return;
  const int i = (int)((idx % per_rhs) / 3);
  const int* row = nbr + (size_t)(t0 + i / kTile) * max_nbr;
  const size_t stride = nrhs * per_rhs;
  float v = 0.0f;
  for (int s = 0; s < max_nbr && row[s] >= 0; ++s) v += part[s * stride + idx];
  out[idx] = v;
}

// Blocks of near_pair_kernel<WALL, NRHS, BOX, POLY> that fit on the card
// at once, per device (0 if the runtime cannot say).
template <bool WALL, int NRHS, bool BOX, bool POLY>
int resident_blocks() {
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, near_pair_kernel<WALL, NRHS, BOX, POLY>, kTile, 0)
               != cudaSuccess)
      return 0;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

// The inputs of one launch.
struct Args {
  const float* pos;
  const int* cell;
  const unsigned char* live;
  const float* force;
  const float* ahat;
  const int* pairs;
  const int* n_pairs;
  int n_pad;
  int t0;
  int nt;
  float h_floor;
  CellBox box;
  float* part;
};

template <bool WALL, int NRHS, bool BOX, bool POLY>
int launch(int cap, cudaStream_t stream, const Args& g) {
  const int resident = resident_blocks<WALL, NRHS, BOX, POLY>();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = cap < resident ? cap : resident;
  near_pair_kernel<WALL, NRHS, BOX, POLY><<<grid, kTile, 0, stream>>>(
      g.pos, g.cell, g.live, g.force, g.ahat,
      reinterpret_cast<const int4*>(g.pairs), g.n_pairs, g.n_pad, g.t0, g.nt,
      g.h_floor, g.box, g.part);
  return static_cast<int>(cudaGetLastError());
}

template <bool WALL, bool BOX, bool POLY>
int launch_k(int nrhs, int cap, cudaStream_t stream, const Args& g) {
  return nrhs == 1 ? launch<WALL, 1, BOX, POLY>(cap, stream, g)
                   : launch<WALL, 2, BOX, POLY>(cap, stream, g);
}

template <bool WALL, bool BOX>
int launch_poly(bool poly, int nrhs, int cap, cudaStream_t stream,
                const Args& g) {
  return poly ? launch_k<WALL, BOX, true>(nrhs, cap, stream, g)
              : launch_k<WALL, BOX, false>(nrhs, cap, stream, g);
}

}  // namespace

extern "C" {

// Blobs per tile: n_pad must be a multiple of it.
int near_sweep_tile() { return kTile; }

// K3: out (nrhs, nt·128, 3) = Σ_j M_ij F_j over the kept pairs of each
// tile of [t0, t0 + nt) and its neighbor tiles: the row-tile slice, the
// whole sweep at (0, t).  n_pad = t·128, nbr (t, max_nbr); pairs (cap, 4)
// int32 with its used length in device memory at n_pairs, every used pair
// holding a tile of the slice; part holds max_nbr·nrhs·nt·128·3 floats of
// scratch (only the used slots are written and read).  box_x > 0 selects
// the box form: the film's (box_x, box_y) in units of a and its (gx, gy)
// cells; box_x = 0 the open form.  ahat: the n_pad radii in units of a
// (the POLY form), or NULL for one radius.
int near_sweep(const float* pos, const int* cell, const unsigned char* live,
               const float* force, const float* ahat, const int* nbr,
               const int* pairs, const int* n_pairs, int n_pad, int t0,
               int nt, int max_nbr, int cap, int nrhs, int wall,
               float h_floor, float box_x, float box_y, int gx, int gy,
               float* part, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nrhs != 1 && nrhs != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pad % kTile != 0 || max_nbr < 0 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t0 < 0 || nt < 0 || (t0 + nt) * kTile > n_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_box = box_x > 0.0f;
  if (in_box && !(box_y > 0.0f && gx > 0 && gy > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt == 0) return 0;
  if (cap > 0) {
    const CellBox box{box_x, box_y, in_box ? 1.0f / box_x : 0.0f,
                      in_box ? 1.0f / box_y : 0.0f, gx, gy};
    const Args g{pos, cell, live, force, ahat, pairs, n_pairs, n_pad, t0, nt,
                 h_floor, box, part};
    const bool poly = ahat != nullptr;
    int code;
    if (in_box)
      code = wall ? launch_poly<true, true>(poly, nrhs, cap, stream, g)
                  : launch_poly<false, true>(poly, nrhs, cap, stream, g);
    else
      code = wall ? launch_poly<true, false>(poly, nrhs, cap, stream, g)
                  : launch_poly<false, false>(poly, nrhs, cap, stream, g);
    if (code != 0) return code;
  }
  const size_t total = (size_t)nrhs * nt * kTile * 3;
  const int threads = 256;
  sum_slots_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                     stream>>>(part, nbr, t0, nt * kTile, max_nbr, nrhs, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
