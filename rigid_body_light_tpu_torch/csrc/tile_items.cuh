// Work items of the symmetric sweeps over the upper triangle of 128 × 128
// tile pairs (rpy_pair_sweep.cu: K1; ewald_real_sweep.cu: K4), and their
// second pass.
//
// Items of T = ⌈n/128⌉ tiles, in launch order: the T diagonal pairs (I, I)
// at indices 0..T−1, then every (I, J > I) row-major.  The cheap diagonal
// items (half their pairs) lead, so a launch ends on full items of equal
// cost.  A block decodes its item from its index; the Python mirror is
// rigid_body_light_tpu_torch/ops/tiles.py::upper_tile_items.
//
// Each item writes a row partial (its 128 rows) and a column partial (its
// 128 columns) of nf = 3·nrhs floats a blob, (items, nf, 128) each, every
// element written by exactly one block; sum_items_kernel adds them for
// every blob in a fixed order.  No atomics: launches are bitwise
// repeatable.

#pragma once

#include <cuda_runtime.h>

namespace tile_items {
namespace {  // each including source gets its own copy

constexpr int kTile = 128;

__device__ __forceinline__ long long off_diagonal_before(int I, int T) {
  return (long long)I * (2 * T - I - 1) / 2;
}

__device__ __forceinline__ int item_index(int I, int J, int T) {
  return I == J ? I : T + (int)off_diagonal_before(I, T) + (J - I - 1);
}

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

// Second pass: out[k][i][c] = Σ_{J ≥ I} row_part[(I, J)][3k+c][r] +
// Σ_{I' ≤ I} col_part[(I', I)][3k+c][r] for i = 128·I + r, in that fixed
// order.
__global__ void sum_items_kernel(const float* __restrict__ row_part,
                                 const float* __restrict__ col_part,
                                 int n, int n_tiles, int nf,
                                 float* __restrict__ out) {  // (nrhs, n, 3)
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nf * n) return;
  const int comp = idx / n;
  const int i = idx - comp * n;
  const int I = i / kTile, r = i % kTile;
  float s = 0.0f;
  for (int J = I; J < n_tiles; ++J)
    s += row_part[((size_t)item_index(I, J, n_tiles) * nf + comp) * kTile + r];
  for (int I2 = 0; I2 <= I; ++I2)
    s += col_part[((size_t)item_index(I2, I, n_tiles) * nf + comp) * kTile + r];
  out[((size_t)(comp / 3) * n + i) * 3 + comp % 3] = s;
}

// Launch the second pass for n blobs and nrhs right-hand sides.
cudaError_t sum_items(const float* row_part, const float* col_part, int n,
                      int nrhs, float* out, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const int nf = 3 * nrhs;
  const int threads = 256;
  const int blocks = (nf * n + threads - 1) / threads;
  sum_items_kernel<<<blocks, threads, 0, stream>>>(row_part, col_part, n,
                                                   n_tiles, nf, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tile_items
