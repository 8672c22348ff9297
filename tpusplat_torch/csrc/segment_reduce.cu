// Per-Gaussian sum of id-sorted gradient rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusplat/ops/rasterize_pallas.py::_segment_reduce_kernel
// in its dense mode (launched by _run_segment_reduce_general, pallas_call at
// rasterize_pallas.py:905, via _run_segment_reduce from _pack_gather_bwd).
// Plain version: tpusplat_torch/ops/segment_reduce.py::segment_reduce_plain
// (index_add_). The streamed-target and multi-range modes of the TPU kernel
// (parallel/compact_grad.py) are not ported.
//
// What it computes: rows [9, stride] float32 hold one gradient row per
// instance slot (uv.x, uv.y, conic a, b, c, opacity, r, g, b), sorted by the
// Gaussian id gid [R] int32; bounds [n + 1] int32 gives each id g its run
// [bounds[g], bounds[g+1]). out [9, n] float32 (the layout of the gathered
// table) gets, for each g, the sum of the rows of its run whose id equals g.
// A row with an id outside [0, n) -- a sentinel slot past the last instance,
// whose values are stale memory the backward blend never wrote -- is skipped
// by a select (never multiplied by 0, which would turn a NaN into NaN).
//
// Design: one warp per Gaussian. Its lanes read the run's rows strided by 32
// (coalesced along each of the 9 rows), keep 9 partial sums, and combine them
// with a fixed butterfly of shuffles. No atomics: every output belongs to one
// warp, and the order of the sum is fixed, so the result is deterministic.
// A warp suits the garden shapes' runs (about 3 rows on average, thousands
// for the largest Gaussians) without a second pass.
//
// Bound: bytes. It must read 10 x 4 B per row (9 values and the id) and write
// 9 x 4 B per Gaussian: at the garden shapes (4.2M rows, 1.4M Gaussians)
// 0.22 GB, 0.07 ms at 3.35 TB/s; the 9 adds per row are far below the rate.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void segment_reduce_kernel(const float* __restrict__ rows, long long stride,
                                      const int* __restrict__ gid,
                                      const int* __restrict__ bounds, int n,
                                      float* __restrict__ out) {
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // uniform across the warp
  const int g = static_cast<int>(w);
  const int lo = bounds[g];
  const int hi = bounds[g + 1];
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  for (int r = lo + lane; r < hi; r += 32) {
    if (gid[r] == g) {  // g lies in [0, n): any other id is dropped here
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] += rows[k * stride + r];
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (lane == k) out[static_cast<long long>(k) * n + g] = acc[k];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). n >= 1.
extern "C" int tpusplat_segment_reduce(const void* rows, long long stride, const void* gid,
                                       const void* bounds, int n, void* out, void* stream) {
  const long long threads = 32LL * n;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  segment_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(gid),
      static_cast<const int*>(bounds), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
