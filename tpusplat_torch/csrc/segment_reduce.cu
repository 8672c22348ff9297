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
// instance slot (uv.x, uv.y, conic a, b, c, opacity, r, g, b), sorted by
// Gaussian id; bounds [n + 1] int32 gives each id g its run
// [bounds[g], bounds[g+1]). out [9, n] float32 (the layout of the gathered
// table) gets, for each g, the sum of the rows of its run. The ids are not
// read: bounds from a left searchsorted of the sorted ids put every row of
// g's run at id g, and every row with an id outside [0, n) -- the sentinel
// slots past the last instance, whose values are stale memory the backward
// blend never wrote -- before bounds[0] or from bounds[n] on, outside every
// run.
//
// Bound: bytes. It must read 9 x 4 B per row in a run and the bounds, and
// write 9 x 4 B per Gaussian: at the garden shapes (4.2M rows, 1.4M
// Gaussians) about 0.21 GB, 0.06 ms at 3.35 TB/s; the 9 adds per row are
// far below the rate.
//
// Design: a warp owns 32 consecutive Gaussians, as a segment of the TPU
// kernel owned GB consecutive ids over one contiguous row range. Lane i sums
// Gaussian g0 + i over its run alone. The runs of neighbouring lanes are
// neighbouring in the sorted rows, so each of the warp's loads of a row k
// falls in one short span and coalesces, and the 9 sums go out as 9 stores
// of 32 consecutive floats. At about 3 rows a Gaussian this keeps every lane
// busy, where a warp per Gaussian (the first version) idled 29 of 32 lanes
// and paid a 45-shuffle butterfly per Gaussian. A run longer than kLongRun
// rows would hold its warp for that many serial steps, so its lane skips it;
// after the short runs, the warp takes the long runs one by one in lane
// order and sums each with all 32 lanes (rows strided by 32, a fixed
// butterfly). No atomics, and every sum has a fixed order: the result is
// bit-equal from launch to launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// A run longer than this many rows is summed by its whole warp. Garden's
// runs average 3 rows and reach 16, so none of them takes the warp path.
constexpr int kLongRun = 32;

__global__ void segment_reduce_kernel(const float* __restrict__ rows, long long stride,
                                      const int* __restrict__ bounds, int n,
                                      float* __restrict__ out) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long gl = first + threadIdx.x;
  const bool own = gl < n;
  const int g = static_cast<int>(own ? gl : 0);
  const int lo = own ? bounds[g] : 0;
  const int hi = own ? bounds[g + 1] : 0;
  const bool is_long = hi - lo > kLongRun;

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  if (!is_long) {
    int r = lo;
    for (; r + 1 < hi; r += 2) {  // two rows a step: 18 loads in flight
      float a[kRows], b[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        a[k] = rows[k * stride + r];
        b[k] = rows[k * stride + r + 1];
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = (acc[k] + a[k]) + b[k];
    }
    if (r < hi) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] += rows[k * stride + r];
    }
  }

  // The long runs, one at a time, with the whole warp.
  unsigned pending = __ballot_sync(kFull, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int a_lo = __shfl_sync(kFull, lo, src);
    const int a_hi = __shfl_sync(kFull, hi, src);
    float s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) s[k] = 0.0f;
    for (int r = a_lo + lane; r < a_hi; r += 32) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) s[k] += rows[k * stride + r];
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_xor_sync(kFull, s[k], o);
    }
    if (lane == src) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = s[k];
    }
  }

  if (own) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[static_cast<long long>(k) * n + g] = acc[k];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). n >= 1.
extern "C" int tpusplat_segment_reduce(const void* rows, long long stride, const void* bounds,
                                       int n, void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) /
                                                kThreads);
  segment_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(bounds), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
