// Sums of id-sorted gradient rows over runs, for Hopper (sm_90a): the three
// modes of one TPU kernel, each with its own entry point.
//
// Replaces the TPU kernel tpusplat/ops/rasterize_pallas.py::_segment_reduce_kernel
// (launched by _run_segment_reduce_general, pallas_call at rasterize_pallas.py:905)
// in each of its modes:
//   * dense (tpusplat_segment_reduce): one sum per Gaussian id, from
//     _run_segment_reduce via _pack_gather_bwd;
//   * streamed-target (tpusplat_segment_reduce_targets): one sum per entry
//     of a target list, from parallel/compact_grad.py:247;
//   * multi-range (tpusplat_segment_reduce_multirange): one sum per local id
//     over S id-sorted blocks, from parallel/compact_grad.py:289.
// Plain versions: tpusplat_torch/ops/segment_reduce.py::segment_reduce_plain,
// segment_reduce_targets_plain and segment_reduce_multirange_plain (index_add_).
//
// Rows [9, stride] float32 hold one gradient row per instance slot (uv.x,
// uv.y, conic a, b, c, opacity, r, g, b); out [9, m] float32 is the layout
// of the gathered table. The dense mode also sums the surfels' 18 rows
// (tpusplat_segment_reduce_rows): the same kernel, templated on the row
// count, so its 9-row instance is the code it was. A row whose id lies outside [0, n) -- the sentinel
// slots past the last instance, whose values are stale memory the backward
// blend never wrote -- lies in no run and is never read, even as NaN.
//
// All three modes share one summation, add_run: a warp owns 32 consecutive
// outputs, as a segment of the TPU kernel owned GB consecutive ids over one
// contiguous row range, and lane i sums output j0 + i over its runs alone,
// rows left to right. The runs of neighbouring lanes are neighbouring in
// the sorted rows, so each of the warp's loads of a row k falls in one
// short span and coalesces, and the 9 sums go out as 9 stores of 32
// consecutive floats. A run longer than kLongRun rows would hold its warp
// for that many serial steps, so its lane skips it; the warp then takes
// those runs one by one in lane order and sums each with all 32 lanes (rows
// strided by 32, a fixed butterfly). No atomics, and every sum has a fixed
// order (blocks in order, rows left to right): the result is bit-equal from
// launch to launch.
//
// Where the modes differ is how a lane finds its runs.
//
// Dense: from bounds [m + 1] (left searchsorted of the sorted ids), passed
// as lo = bounds[:-1] and hi = bounds[1:], two views of one array; the ids
// are not read. Bound: bytes, 9 x 4 B per row in a run, the bounds, 9 x 4 B
// per output: at the garden shapes (4.2M rows, 1.4M Gaussians) about
// 0.21 GB, 0.06 ms at 3.35 TB/s; the 9 adds per row are far below the rate.
// Reading lo and hi where one bounds array would do measured the same as a
// kernel reading bounds alone (0.0758 against 0.0765 ms, NVIDIA H100 80GB
// HBM3 at 700 W, chip_smoke.py).
//
// Streamed-target and multi-range: from the sorted ids themselves, in the same
// launch. Searching every output's run bounds with torch.searchsorted before
// the kernel (two searches of 1.1M targets; an [S, n + 1] query array, a
// batched search and two [S, n] copies for the multi-range mode) costs five or
// more launches and more time than the sums, where the outputs' runs are found
// far more cheaply together: a warp first finds the row span of its 32 outputs
// with one search of the sorted ids per span end, shared by the warp: the lanes
// are split into groups of P, each group searching one end P ways at a time (P
// probes a step, one vote; log_(P+1) of the ids' length steps, the first of
// which hit the same cache lines in every warp). A lane then finds its own run
// by a binary search inside the span, which is short (its rows are the 32
// outputs' runs) and already in cache, and sums it with add_run. So the runs
// are exactly those of a left searchsorted of the output's id and of the
// id + 1, and every output adds the same rows in the same order as the dense
// kernel does over searched bounds: the sums are bit-equal to it.
//  * Streamed-target: output j of m is the sum of the rows whose sorted id
//    (gid [r]) equals targets[j], 0 for a target outside [0, n). The span is
//    [lower bound of the warp's least live target, lower bound of its
//    largest + 1), two groups of 16 lanes; a warp whose targets are all
//    outside [0, n) (the sentinel n pads each owner block of the compact
//    exchange: three quarters of the garden strip's slots) only writes its
//    zeros. Targets need not be sorted: any live target's run lies in the
//    span, which for ascending targets (the real path's) holds just their
//    runs. Bound: bytes, 9 x 4 B per row in a live target's run, the
//    targets, 9 x 4 B per output: at the garden strip (1.04M rows, 1.13M
//    targets) 82 MB, 0.025 ms.
//  * Multi-range: ids [S][len] hold S blocks, each sorted, rows in the same
//    columns; output j of m is the sum over b < S, in order, of block b's
//    rows with id j. The warp's span in block b is [lower bound of j0,
//    lower bound of min(j0 + 32, m)); eight groups of four lanes search the
//    span ends of four blocks at once (five ways a step; rounds of four
//    blocks past S = 4), so a warp pays one search of a block's length, not
//    S. A block wholly of sentinels gives empty spans, which are skipped.
//    Ids may repeat within a block. Bound: bytes, 9 x 4 B and the id per
//    row with an id in [0, m), 9 x 4 B per output (a block's sentinel tail
//    is found by a search, not read): at the garden strip (4 blocks of
//    281,600, 265,704 live rows, 350,000 outputs) 23.2 MB, 0.0069 ms.
// A search reads a few ids in a block's sentinel tail; no gradient row at
// or past a block's first sentinel is read.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 9;
constexpr int kSurfelRows = 18;  // the surfels' slab (ops/surfel.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
// A run longer than this many rows is summed by its whole warp. Garden's
// runs average 3 rows and reach 16, so none of them takes the warp path.
constexpr int kLongRun = 32;

// Adds the R rows of run [lo, hi) to acc: a lane alone for a short run; for
// the warp's long runs the whole warp afterwards, in lane order.
template <int R = kRows>
__device__ __forceinline__ void add_run(const float* __restrict__ rows, long long stride,
                                        int lo, int hi, int lane, float (&acc)[R]) {
  const bool is_long = hi - lo > kLongRun;
  if (!is_long) {
    int r = lo;
    for (; r + 1 < hi; r += 2) {  // two rows a step: 18 loads in flight
      float a[R], b[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        a[k] = rows[k * stride + r];
        b[k] = rows[k * stride + r + 1];
      }
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = (acc[k] + a[k]) + b[k];
    }
    if (r < hi) {
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] += rows[k * stride + r];
    }
  }

  // The long runs, one at a time, with the whole warp.
  unsigned pending = __ballot_sync(kFull, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int a_lo = __shfl_sync(kFull, lo, src);
    const int a_hi = __shfl_sync(kFull, hi, src);
    float s[R];
#pragma unroll
    for (int k = 0; k < R; ++k) s[k] = 0.0f;
    for (int r = a_lo + lane; r < a_hi; r += 32) {
#pragma unroll
      for (int k = 0; k < R; ++k) s[k] += rows[k * stride + r];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_xor_sync(kFull, s[k], o);
    }
    if (lane == src) {
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] += s[k];
    }
  }
}

// Dense mode over R rows: 9 for the Gaussians' slab, 18 for the surfels'.
template <int R>
__global__ void segment_reduce_kernel(const float* __restrict__ rows, long long stride,
                                      const int* __restrict__ lo, const int* __restrict__ hi,
                                      int rps, int m, float* __restrict__ out) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  const long long jl = first + threadIdx.x;
  const bool own = jl < m;
  const int j = static_cast<int>(own ? jl : 0);

  float acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.0f;
  for (int b = 0; b < rps; ++b) {  // rps is the same for the whole warp
    const long long at = static_cast<long long>(b) * m + j;
    add_run<R>(rows, stride, own ? lo[at] : 0, own ? hi[at] : 0, lane, acc);
  }

  if (own) {
#pragma unroll
    for (int k = 0; k < R; ++k) out[static_cast<long long>(k) * m + j] = acc[k];
  }
}

unsigned blocks_for(int m) {
  return static_cast<unsigned>((static_cast<long long>(m) + kThreads - 1) / kThreads);
}

// First index in the sorted a[lo, hi) whose value is >= key (hi if none).
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// lower_bound for each group of P lanes (lanes [g P, (g + 1) P)), each with
// its own range and key, searched P ways a step: the group's P probes split
// [lo, hi) into P + 1 parts, and one vote says which part holds the bound.
// Every lane of the warp calls it; a group is done when lo == hi.
template <int P>
__device__ __forceinline__ int group_lower_bound(const int* __restrict__ a, int lo, int hi,
                                                 int key, int lane) {
  static_assert(P >= 1 && P <= 16 && (P & (P - 1)) == 0, "P: a power of two up to 16");
  const int first = lane & ~(P - 1);
  const unsigned group = ((1u << P) - 1u) << first;
  const int q = lane - first;
  while (__any_sync(kFull, lo < hi)) {
    const bool open = lo < hi;
    const int probe = lo + static_cast<int>(static_cast<unsigned long long>(q + 1) *
                                            static_cast<unsigned>(hi - lo) / (P + 1));
    const bool below = open && a[probe] < key;
    const int c = __popc(__ballot_sync(kFull, below) & group);  // probes below the bound
    const int after = __shfl_sync(kFull, probe, first + (c > 0 ? c - 1 : 0));
    const int at = __shfl_sync(kFull, probe, first + (c < P ? c : P - 1));
    if (open) {
      if (c > 0) lo = after + 1;
      if (c < P) hi = at;
    }
  }
  return lo;
}

__global__ void targets_kernel(const float* __restrict__ rows, long long stride,
                               const int* __restrict__ gid, int r,
                               const int* __restrict__ targets, int m, int n,
                               float* __restrict__ out) {
  const long long jl = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool own = jl < m;
  const int j = static_cast<int>(own ? jl : 0);
  const int t = own ? targets[j] : -1;
  const bool live = own && t >= 0 && t < n;

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  if (__any_sync(kFull, live)) {
    // The warp's span: lanes 0-15 search its least live target, lanes
    // 16-31 its largest + 1 (at most n, no overflow).
    const int tmin = __reduce_min_sync(kFull, live ? t : INT_MAX);
    const int tmax = __reduce_max_sync(kFull, live ? t : INT_MIN);
    const int end = group_lower_bound<16>(gid, 0, r, lane < 16 ? tmin : tmax + 1, lane);
    const int span_lo = __shfl_sync(kFull, end, 0);
    const int span_hi = __shfl_sync(kFull, end, 16);
    int lo = 0, hi = 0;
    if (live) {
      lo = lower_bound(gid, span_lo, span_hi, t);
      hi = lower_bound(gid, lo, span_hi, t + 1);
    }
    add_run(rows, stride, lo, hi, lane, acc);
  }

  if (own) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[static_cast<long long>(k) * m + j] = acc[k];
  }
}

// Groups of kGroupLanes lanes search the two ends of kPerRound blocks' spans
// at once.
constexpr int kGroupLanes = 4;
constexpr int kPerRound = 32 / (2 * kGroupLanes);

__global__ void multirange_kernel(const float* __restrict__ rows, long long stride,
                                  const int* __restrict__ ids, int len, int nblocks, int m,
                                  float* __restrict__ out) {
  const long long jl = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool own = jl < m;
  const int j = static_cast<int>(own ? jl : 0);
  const long long j0 = jl - lane;  // the warp's first output

  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.0f;
  if (j0 < m) {  // the same for the whole warp
    // Group g searches block b0 + g / 2 for the span's start (g even) or
    // end (g odd); its keys are at most m, its offsets below 2^31.
    const int g = lane / kGroupLanes;
    const int key = (g & 1) ? static_cast<int>(j0 + 32 < m ? j0 + 32 : m)
                            : static_cast<int>(j0);
    for (int b0 = 0; b0 < nblocks; b0 += kPerRound) {
      const int b = b0 + (g >> 1);
      const int base = b < nblocks ? b * len : 0;
      const int end =
          group_lower_bound<kGroupLanes>(ids, base, b < nblocks ? base + len : base, key, lane);
      const int here = nblocks - b0 < kPerRound ? nblocks - b0 : kPerRound;
      for (int i = 0; i < here; ++i) {  // blocks in order
        const int span_lo = __shfl_sync(kFull, end, 2 * i * kGroupLanes);
        const int span_hi = __shfl_sync(kFull, end, (2 * i + 1) * kGroupLanes);
        if (span_lo == span_hi) continue;  // the same for the whole warp
        int lo = 0, hi = 0;
        if (own) {
          lo = lower_bound(ids, span_lo, span_hi, j);
          hi = lower_bound(ids, lo, span_hi, j + 1);
        }
        add_run(rows, stride, lo, hi, lane, acc);
      }
    }
  }

  if (own) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) out[static_cast<long long>(k) * m + j] = acc[k];
  }
}

}  // namespace

// lo and hi are [rps][m] int32 row offsets into rows. Returns
// cudaGetLastError() after the launch (0 on success). m >= 1.
extern "C" int tpusplat_segment_reduce(const void* rows, long long stride, const void* lo,
                                       const void* hi, int rps, int m, void* out, void* stream) {
  segment_reduce_kernel<kRows><<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(lo),
      static_cast<const int*>(hi), rps, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The dense mode over nrows rows [nrows, stride] into out [nrows, m]: 9
// (the call above) or 18, the surfels' slab. Returns cudaErrorInvalidValue
// for another count.
extern "C" int tpusplat_segment_reduce_rows(const void* rows, long long stride, const void* lo,
                                            const void* hi, int rps, int m, int nrows,
                                            void* out, void* stream) {
  const auto* r = static_cast<const float*>(rows);
  const auto* l = static_cast<const int*>(lo);
  const auto* h = static_cast<const int*>(hi);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nrows == kRows) {
    segment_reduce_kernel<kRows><<<blocks_for(m), kThreads, 0, s>>>(r, stride, l, h, rps, m, o);
  } else if (nrows == kSurfelRows) {
    segment_reduce_kernel<kSurfelRows><<<blocks_for(m), kThreads, 0, s>>>(r, stride, l, h, rps,
                                                                         m, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Streamed-target mode: gid [r] int32 sorted ascending (row offsets into
// rows), targets [m] int32, out [9, m]. Returns cudaGetLastError() after the
// launch. m >= 1.
extern "C" int tpusplat_segment_reduce_targets(const void* rows, long long stride,
                                               const void* gid, int r, const void* targets,
                                               int m, int n, void* out, void* stream) {
  targets_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(gid), r,
      static_cast<const int*>(targets), m, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Multi-range mode: ids [nblocks][len] int32, each block sorted ascending
// (row offsets into rows, nblocks x len < 2^31), out [9, m]. Returns
// cudaGetLastError() after the launch. m >= 1, nblocks >= 1.
extern "C" int tpusplat_segment_reduce_multirange(const void* rows, long long stride,
                                                  const void* ids, int len, int nblocks, int m,
                                                  void* out, void* stream) {
  multirange_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), stride, static_cast<const int*>(ids), len, nblocks, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
