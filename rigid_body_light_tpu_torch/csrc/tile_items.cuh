// Work items of the symmetric sweeps over the upper triangle of 128 × 128
// tile pairs (rpy_pair_sweep.cu: K1; ewald_real_sweep.cu: K4), the blocks
// that walk them, and their second pass.
//
// Tiles.  T = ⌈n/128⌉ tiles of 128 blobs; an item is a tile pair (I, J ≥ I).
//
// Groups.  Up to 2·kMaxGroups tiles (65,536 blobs) every tile is its own
// group, G = T: a unit is one item.  Past it the tiles are cut into G =
// kMaxGroups groups of consecutive tiles whose sizes differ by at most
// one: group p holds tiles [⌊pT/G⌋, ⌊(p+1)T/G⌋), S = ⌈T/G⌉ ≥ 3 at most.
// A block takes one unit, a group pair (P, Q ≥ P), in launch order: the
// G diagonal units (P, P) at indices 0..G−1, then every (P, Q > P)
// row-major.  A block decodes its unit from its index (unit_of) and walks
// its items row by row, I over group P, J over group Q (J ≥ I on a
// diagonal unit).  A grouped launch has G(G+1)/2 = 32,896 blocks of
// nearly equal cost at every n, some 25 waves on an H100: fewer, longer
// units leave a tail (2,145 blocks of 4 items at 16,512 blobs took 10%
// longer than one item a block, PERF.md §6).  The Python mirror is
// rigid_body_light_tpu_torch/ops/tiles.py (sweep_groups, group_items,
// sum_order).
//
// Partials.  A unit owns a row partial and a column partial of S slots,
// one per tile of its group, each of nf = 3·nrhs floats a blob, (units, S,
// nf, 128) each.  Thread t carries row t of tile I through the items of
// that row and writes the row slot once; it writes column t of tile J's
// slot at the unit's first row and adds to it at every later row
// (store_col).  Every element has one writer, the same thread each time;
// sum_items_kernel adds a blob's slots in a fixed order.  No atomics:
// launches are bitwise repeatable.
//
// Scratch.  2·U·S·nf·128 floats, U = G(G+1)/2.  One item a block it is
// T(T+1)·128·nf with T ≤ 2·kMaxGroups; grouped, G·S < T + G < 2T.  Either
// way it is below 2·(kMaxGroups + 1)·(n + 128)·nf floats — O(n), where
// one partial an item at every n was T(T+1)·128·nf, O(n²).  At 409,600
// blobs and 2 RHS it is 2.63 GB (one partial an item: 31.5 GB).

#pragma once

#include <cuda_runtime.h>

namespace tile_items {
namespace {  // each including source gets its own copy

constexpr int kTile = 128;
constexpr int kMaxGroups = 256;

// The launch's geometry for n blobs; passed to the kernels by value.
struct Groups {
  int n_tiles;   // T
  int group;     // S = ⌈T/G⌉, the slots a unit's partial holds
  int n_groups;  // G
  int units;     // G(G+1)/2 blocks
};

inline Groups groups_of(int n) {
  Groups g;
  g.n_tiles = (n + kTile - 1) / kTile;
  g.n_groups = g.n_tiles <= 2 * kMaxGroups ? g.n_tiles : kMaxGroups;
  g.group = g.n_groups > 0 ? (g.n_tiles + g.n_groups - 1) / g.n_groups : 1;
  g.units = g.n_groups * (g.n_groups + 1) / 2;
  return g;
}

// First tile of group p (p = G: one past the last tile).
__device__ __forceinline__ int group_start(int p, const Groups& g) {
  return p * g.n_tiles / g.n_groups;
}

// The group of tile X: the last p with group_start(p) ≤ X.
__device__ __forceinline__ int group_of(int X, const Groups& g) {
  return ((X + 1) * g.n_groups - 1) / g.n_tiles;
}

__device__ __forceinline__ long long off_diagonal_before(int I, int T) {
  return (long long)I * (2 * T - I - 1) / 2;
}

// Index of the pair (I, J ≥ I) of T in launch order.
__device__ __forceinline__ int item_index(int I, int J, int T) {
  return I == J ? I : T + (int)off_diagonal_before(I, T) + (J - I - 1);
}

// The pair (I, J ≥ I) of T at launch index ``item``.
__device__ __forceinline__ void item_tiles(int item, int T, int& I, int& J) {
  if (item < T) {
    I = J = item;
    return;
  }
  const long long p = item - T;
  const double b = 2.0 * T - 1.0;
  int r = (int)((b - sqrt(b * b - 8.0 * (double)p)) * 0.5);
  r = max(0, min(r, T - 2));
  while (r > 0 && off_diagonal_before(r, T) > p) --r;
  while (off_diagonal_before(r + 1, T) <= p) ++r;
  I = r;
  J = (int)(p - off_diagonal_before(r, T)) + r + 1;
}

// A block's unit: tiles I ∈ [I0, I1) of group P against J ∈ [J0, J1) of
// group Q, row by row, J from first_col(I); slot I − I0 of its row partial
// and J − J0 of its column partial.
struct Unit {
  int I0, I1, J0, J1;
  bool diagonal;  // P == Q
  __device__ __forceinline__ int first_col(int I) const {
    return diagonal ? I : J0;
  }
};

__device__ __forceinline__ Unit unit_of(int unit, const Groups& g) {
  int P, Q;
  item_tiles(unit, g.n_groups, P, Q);
  Unit u;
  u.I0 = group_start(P, g);
  u.I1 = group_start(P + 1, g);
  u.J0 = group_start(Q, g);
  u.J1 = group_start(Q + 1, g);
  u.diagonal = P == Q;
  return u;
}

// Slot s (nf·128 floats) of unit ``unit``'s partial.
__device__ __forceinline__ float* slot(float* part, int unit, int s,
                                       const Groups& g, int nf) {
  return part + ((size_t)unit * g.group + s) * nf * kTile;
}

// An element of a column slot: written at the unit's first row, added to
// at every later row, by the same thread.
__device__ __forceinline__ void store_col(float* p, float v, bool first) {
  if (first)
    *p = v;
  else
    *p += v;
}

// Second pass: for blob i = 128·X + r of group P, slot x = X −
// group_start(P), out[k][i][c] = Σ_{Q ≥ P} row_part[(P, Q)][x][3k+c][r] +
// Σ_{P' ≤ P} col_part[(P', P)][x][3k+c][r], in that fixed order.
__global__ void sum_items_kernel(const float* __restrict__ row_part,
                                 const float* __restrict__ col_part, int n,
                                 Groups g, int nf,
                                 float* __restrict__ out) {  // (nrhs, n, 3)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nf * n) return;
  const int comp = idx / n;
  const int i = idx - comp * n;
  const int X = i / kTile, r = i % kTile;
  const int P = group_of(X, g), x = X - group_start(P, g);
  const int G = g.n_groups;
  float s = 0.0f;
  for (int Q = P; Q < G; ++Q)
    s += row_part[(((size_t)item_index(P, Q, G) * g.group + x) * nf + comp)
                  * kTile + r];
  for (int P2 = 0; P2 <= P; ++P2)
    s += col_part[(((size_t)item_index(P2, P, G) * g.group + x) * nf + comp)
                  * kTile + r];
  out[((size_t)(comp / 3) * n + i) * 3 + comp % 3] = s;
}

// Launch the second pass for n blobs and nrhs right-hand sides.
cudaError_t sum_items(const float* row_part, const float* col_part, int n,
                      int nrhs, float* out, cudaStream_t stream) {
  const int nf = 3 * nrhs;
  const int threads = 256;
  const int blocks = (nf * n + threads - 1) / threads;
  sum_items_kernel<<<blocks, threads, 0, stream>>>(row_part, col_part, n,
                                                   groups_of(n), nf, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tile_items
