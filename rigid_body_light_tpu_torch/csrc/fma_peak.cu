// FP32 FMA peak probe for Hopper (sm_90a).
//
//   P fma_peak  replaces `kernel` in measure_vpu_peak
//               (scripts/tpu_kernel_roofline.py:53):
//               out_i = Σ_j chain(x_i·c_j), chain = kChain steps of
//               v = v·1.000001 + c_j.  No physics: 2·kChain + 2 flop per
//               (i, j), unambiguous, in the pair sweeps' tile/loop skeleton.
//
// What bounds it on the card: arithmetic, by construction.  The inputs are
// 2·n floats and the output n.
//
// Design.  The TPU probe runs one program per 128 rows, in sequence, each
// looping over all 512-column tiles.  n = 10240 would give 80 blocks for
// 132 SMs, so the grid here is K1's (rpy_pair_sweep.cu): (128-row tiles) ×
// (512-column chunks), one row per thread, per-chunk partial row sums each
// written by one block, and a second pass that adds the chunks in a fixed
// order (no atomics, bitwise repeatable).  One chain per thread would
// measure the FMA latency, not the peak: a thread runs kLanes = 8
// independent chains (8 neighbouring columns) at once, and 4 warps per
// block with several blocks per SM add to that.  The column values come
// from shared memory as two 16-byte broadcast reads per 8 columns, so 512
// of every 530 instructions a warp runs are FMAs.
//
// Each step is one fused multiply-add (fmaf: one rounding); a plain
// float32 multiply then add rounds twice and differs in the last bits.
// Each of a thread's 8 lanes keeps its own partial sum; they are added in a
// fixed order at the end.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;
constexpr int kChunk = 512;
constexpr int kLanes = 8;
constexpr int kChain = 64;
constexpr float kMul = 1.000001f;

__global__ void __launch_bounds__(kRows)
fma_peak_kernel(const float* __restrict__ x,      // (n,)
                const float* __restrict__ c,      // (n,)
                int n,
                float* __restrict__ part) {       // (n_chunks, n)
  __shared__ __align__(16) float s_c[kChunk];
  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + t;
  const int col0 = blockIdx.y * kChunk;
  for (int idx = t; idx < kChunk; idx += kRows) {
    const int j = col0 + idx;
    s_c[idx] = j < n ? c[j] : 0.0f;   // a pad column's chain stays 0
  }
  __syncthreads();
  const float xi = i < n ? x[i] : 0.0f;
  float sum[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) sum[l] = 0.0f;
  for (int j0 = 0; j0 < kChunk; j0 += kLanes) {
    float cj[kLanes], v[kLanes];
    const float4 lo = *reinterpret_cast<const float4*>(&s_c[j0]);
    const float4 hi = *reinterpret_cast<const float4*>(&s_c[j0 + 4]);
    cj[0] = lo.x; cj[1] = lo.y; cj[2] = lo.z; cj[3] = lo.w;
    cj[4] = hi.x; cj[5] = hi.y; cj[6] = hi.z; cj[7] = hi.w;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v[l] = xi * cj[l];
#pragma unroll
    for (int s = 0; s < kChain; ++s) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) v[l] = fmaf(v[l], kMul, cj[l]);
    }
#pragma unroll
    for (int l = 0; l < kLanes; ++l) sum[l] += v[l];
  }
  if (i < n) {
    const float s01 = sum[0] + sum[1], s23 = sum[2] + sum[3];
    const float s45 = sum[4] + sum[5], s67 = sum[6] + sum[7];
    part[(size_t)blockIdx.y * n + i] = (s01 + s23) + (s45 + s67);
  }
}

__global__ void sum_chunks_kernel(const float* __restrict__ part,
                                  int n_chunks, int n,
                                  float* __restrict__ out) {   // (n,)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * n + i];
  out[i] = s;
}

}  // namespace

extern "C" {

int fma_peak_chain() { return kChain; }
int fma_peak_cols_per_chunk() { return kChunk; }

// P: out (n,) = Σ_j chain(x_i·c_j).  part holds ⌈n/512⌉·n floats (scratch,
// fully overwritten).
int fma_peak(const float* x, const float* c, int n, float* part, float* out,
             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return 0;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const dim3 grid((n + kRows - 1) / kRows, n_chunks);
  fma_peak_kernel<<<grid, kRows, 0, stream>>>(x, c, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  sum_chunks_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      part, n_chunks, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
