// Sums of id-sorted gradient rows over runs, for Hopper (sm_90a): the three
// modes of one TPU kernel.
//
// Replaces the TPU kernel tpusplat/ops/rasterize_pallas.py::_segment_reduce_kernel
// (launched by _run_segment_reduce_general, pallas_call at rasterize_pallas.py:905)
// in each of its modes, all through one entry point:
//   * dense (rps = 1, runs from bounds): one sum per Gaussian id, from
//     _run_segment_reduce via _pack_gather_bwd;
//   * streamed-target (rps = 1): one sum per entry of an arbitrary target
//     list, from parallel/compact_grad.py:247;
//   * multi-range (rps = S): one sum per local id over S id-sorted blocks,
//     from parallel/compact_grad.py:289.
// Plain versions: tpusplat_torch/ops/segment_reduce.py::segment_reduce_plain,
// segment_reduce_targets_plain and segment_reduce_multirange_plain (index_add_).
//
// What it computes: rows [9, stride] float32 hold one gradient row per
// instance slot (uv.x, uv.y, conic a, b, c, opacity, r, g, b). Output j of m
// (out [9, m] float32, the layout of the gathered table) is the sum, over
// b < rps in order, of the rows of run [lo[b][j], hi[b][j]) (lo, hi: [rps][m]
// int32; the dense mode passes bounds[:-1] and bounds[1:] of its bounds
// [m + 1], two views of one array). The ids are not read: the
// wrappers build the runs by left searchsorted of the sorted ids, which puts
// every row of target j's run at id j, and every row with an id outside
// [0, n) -- the sentinel slots past the last instance, whose values are stale
// memory the backward blend never wrote -- outside every run; a sentinel
// target gets lo == hi.
//
// Bound: bytes. It must read 9 x 4 B per row in a run and the run bounds, and
// write 9 x 4 B per output: at the garden shapes (4.2M rows, 1.4M Gaussians)
// about 0.21 GB, 0.06 ms at 3.35 TB/s; the 9 adds per row are far below the
// rate.
//
// Design: a warp owns 32 consecutive outputs, as a segment of the TPU
// kernel owned GB consecutive ids over one contiguous row range. Lane i sums
// output j0 + i over its runs alone. In the dense and streamed modes the runs
// of neighbouring lanes are neighbouring in the sorted rows (in the
// multi-range mode, within each block), so each of the warp's loads of a row
// k falls in one short span and coalesces, and the 9 sums go out as 9 stores
// of 32 consecutive floats. At about 3 rows a Gaussian this keeps every lane
// busy, where a warp per Gaussian (the first version) idled 29 of 32 lanes
// and paid a 45-shuffle butterfly per Gaussian. A run longer than kLongRun
// rows would hold its warp for that many serial steps, so its lane skips it;
// after the short runs of a block, the warp takes that block's long runs one
// by one in lane order and sums each with all 32 lanes (rows strided by 32, a
// fixed butterfly), so every output still adds its blocks in block order. No
// atomics, and every sum has a fixed order: the result is bit-equal from
// launch to launch. The dense mode reads lo and hi where one bounds array
// would do; at the garden shapes that measured the same as a kernel reading
// bounds alone (0.0758 against 0.0765 ms, NVIDIA H100 80GB HBM3 at 700 W,
// chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// A run longer than this many rows is summed by its whole warp. Garden's
// runs average 3 rows and reach 16, so none of them takes the warp path.
constexpr int kLongRun = 32;

// Adds the 9 rows of run [lo, hi) to acc: a lane alone for a short run; for
// the warp's long runs the whole warp afterwards, in lane order.
__device__ __forceinline__ void add_run(const float* __restrict__ rows, long long stride,
                                        int lo, int hi, int lane, float (&acc)[kRows]) {
  const bool is_long = hi - lo > kLongRun;
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
      for (int k = 0; k < kRows; ++k) acc[k] += s[k];
    }
  }
}

__global__ void segment_reduce_kernel(const float* __restrict__ rows, long long stride,
                                      const int* __restrict__ lo, const int* __restrict__ hi,
                                      int rps, int m, float* __restrict__ out) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long jl = first + threadIdx.x;
  const bool own = jl < m;
  const int j = static_cast<int>(own ? jl : 0);

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  for (int b = 0; b < rps; ++b) {  // rps is the same for the whole warp
    const long long at = static_cast<long long>(b) * m + j;
    add_run(rows, stride, own ? lo[at] : 0, own ? hi[at] : 0, lane, acc);
  }

  if (own) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[static_cast<long long>(k) * m + j] = acc[k];
  }
}

unsigned blocks_for(int m) {
  return static_cast<unsigned>((static_cast<long long>(m) + kThreads - 1) / kThreads);
}

}  // namespace

// lo and hi are [rps][m] int32 row offsets into rows. Returns
// cudaGetLastError() after the launch (0 on success). m >= 1.
extern "C" int tpusplat_segment_reduce(const void* rows, long long stride, const void* lo,
                                       const void* hi, int rps, int m, void* out, void* stream) {
  segment_reduce_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(lo),
      static_cast<const int*>(hi), rps, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
