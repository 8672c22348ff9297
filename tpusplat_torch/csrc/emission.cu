// Instance emission for tile binning, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusplat/ops/emission.py::_emission_kernel
// (launched by expand_instances_pallas, pallas_call at emission.py:294).
// Plain version: tpusplat_torch/ops/binning.py::expand_instances_sorted.
//
// What it computes, from the depth-ordered meta (ntiles, x0, y0, bbh, ids:
// [n] int32), per instance slot s in [0, capacity): the owner g is the last
// Gaussian in emission order with off[g] <= s (off = the exclusive cumsum
// of ntiles; zero-count Gaussians share their successor's off and are
// never the last). With r = s - off[g]:
//   tile[s] = x0[g] + r / bbh[g] + (y0[g] + r % bbh[g] - row0) * tiles_x
//   gid[s]  = ids[g]
// (x outer, y inner, the reference's preprocess_sort.comp:47-48). Slots at
// or past min(total, capacity) get (INT32_MAX, n_sentinel). And the three
// int32 counters: min(total, capacity), max(total - capacity, 0) and
// total_true - total (0 without total_true), each cast from int64 to int32
// as torch's .to(torch.int32) casts.
//
// Bound: memory. The five [n] int32 meta arrays are read once and two
// [capacity] int32 written: at the garden shapes (1.4M Gaussians, about
// 4.4M slots) 63 MB, 0.019 ms at 3.35 TB/s. What cost the first version
// was around the kernel: its wrapper's eleven launches (an int64 cumsum,
// the clamp and cast of the offsets, the counters as six small ops), and a
// 21-step binary search over all of off in global memory per slot, each
// step a dependent load.
//
// Design: two kernels behind one entry point, and no other launch.
//  * scan_kernel: block b scans its chunk of ntiles (2^shift Gaussians, at
//    most kMaxChunks chunks) and writes each Gaussian's offset within the
//    chunk (int32, clamped at INT32_MAX) and the chunk's sum (int64).
//  * emit_kernel: block b takes tile b, the kItems items [b kItems,
//    (b + 1) kItems) of the merge of the offsets with the slots (a
//    Gaussian before a slot where off <= slot). It first scans the chunk
//    sums into shared memory, so off[g] = pre[g >> shift] + local[g], and
//    the total; two warps then find the tile's two ends on the merge path
//    by a 32-way search, one vote a step. A tile so holds at most kItems
//    slots and kItems Gaussians, whatever the counts (a Gaussian that owns
//    more slots than a tile spans several tiles; a run of zero-count
//    Gaussians spans several tiles with no slot); the owners of its slots
//    are its Gaussians and the one before them. The block stages their
//    offsets in shared memory; each thread finds its slots' owners there
//    by a binary search, reads their meta (neighbouring slots share
//    owners, so the reads hit the cache) and writes tile and gid
//    coalesced. The kernel waits on memory more than it moves it: one tile
//    a block keeps more tiles in flight on an SM than persistent blocks
//    walking several tiles each did, measured on the card.
// Offsets at or past INT32_MAX (a total past it) compare greater than every
// slot, so they are clamped there. The TPU kernel's workarounds do not
// carry over: Hopper has integer division and scattered stores, so there is
// no 8/8/8-bit packed meta and no 255-tile-row limit, no telescoping matmul
// for the owner lookup, and no float reciprocal.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;        // Gaussians a scan step covers
constexpr int kPer = kChunk / kThreads;
constexpr int kMaxChunks = 2048;    // chunk sums an emission block scans
constexpr int kChunkPer = kMaxChunks / kThreads;
constexpr int kItems = 2048;        // merge items (Gaussians and slots) a tile
constexpr int kMinShift = 11;       // log2(kChunk)
constexpr unsigned kFull = 0xffffffffu;

// Exclusive scan of one value a thread over the block; *total gets the sum.
__device__ __forceinline__ long long block_scan(long long v, long long* total) {
  __shared__ long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  const long long ex = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is free again
  return ex;
}

__global__ void __launch_bounds__(kThreads)
    scan_kernel(const int* __restrict__ ntiles, int n, int shift, int* __restrict__ local,
                long long* __restrict__ chunk_sums) {
  __shared__ int buf[kChunk];
  const long long g0 = static_cast<long long>(blockIdx.x) << shift;
  const long long g_end = min(g0 + (1LL << shift), static_cast<long long>(n));
  long long carry = 0;
  for (long long s0 = g0; s0 < g_end; s0 += kChunk) {
    const int m = static_cast<int>(min(static_cast<long long>(kChunk), g_end - s0));
    for (int i = threadIdx.x; i < kChunk; i += kThreads) buf[i] = i < m ? ntiles[s0 + i] : 0;
    __syncthreads();
    int v[kPer];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      v[k] = buf[threadIdx.x * kPer + k];
      sum += v[k];
    }
    long long step;
    long long ex = carry + block_scan(sum, &step);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      buf[threadIdx.x * kPer + k] = static_cast<int>(min(ex, static_cast<long long>(INT_MAX)));
      ex += v[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) local[s0 + i] = buf[i];
    __syncthreads();
    carry += step;
  }
  if (threadIdx.x == 0) chunk_sums[blockIdx.x] = carry;
}

// off[g], clamped at INT32_MAX.
__device__ __forceinline__ int offset(const int* __restrict__ local, const long long* pre,
                                      int shift, long long g) {
  return static_cast<int>(
      min(pre[g >> shift] + __ldg(local + g), static_cast<long long>(INT_MAX)));
}

// The number of Gaussians among the first d items of the merge: the least
// i in [max(0, d - capacity), min(d, n)] with off[i] > d - 1 - i (the slot
// the diagonal meets), found by the calling warp, 32 probes a step.
__device__ long long merge_split(long long d, int n, int capacity,
                                 const int* __restrict__ local, const long long* pre,
                                 int shift) {
  const int lane = threadIdx.x & 31;
  long long lo = max(0LL, d - capacity);
  long long hi = min(d, static_cast<long long>(n));
  while (hi - lo > 32) {
    const long long pos = lo + (hi - lo) * (lane + 1) / 33;
    const bool before = offset(local, pre, shift, pos) <= d - 1 - pos;
    const int c = __popc(__ballot_sync(kFull, before));  // probes before the diagonal
    const long long p_lo = __shfl_sync(kFull, pos, c > 0 ? c - 1 : 0);
    const long long p_hi = __shfl_sync(kFull, pos, c < 32 ? c : 31);
    if (c > 0) lo = p_lo + 1;
    if (c < 32) hi = p_hi;
  }
  const long long pos = lo + lane;
  const bool before = pos < hi && offset(local, pre, shift, pos) <= d - 1 - pos;
  return lo + __popc(__ballot_sync(kFull, before));
}

// Block b: tile b of the merge, items [b kItems, (b + 1) kItems).
__global__ void __launch_bounds__(kThreads)
    emit_kernel(const int* __restrict__ local, const long long* __restrict__ chunk_sums,
                int nb, int shift, const int* __restrict__ x0, const int* __restrict__ y0,
                const int* __restrict__ bbh, const int* __restrict__ ids, int n,
                const long long* __restrict__ total_true, int capacity, int tiles_x, int row0,
                int n_sentinel, int* __restrict__ tile, int* __restrict__ gid,
                int* __restrict__ counters) {
  __shared__ long long pre[kMaxChunks];  // exclusive prefix of the chunk sums
  __shared__ int w_off[kItems + 1];      // the offsets of the tile's owners
  __shared__ long long split[2];
  long long total;
  {
    long long v[kChunkPer];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      const int c = threadIdx.x * kChunkPer + k;
      v[k] = c < nb ? chunk_sums[c] : 0;
      sum += v[k];
    }
    long long ex = block_scan(sum, &total);
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      pre[threadIdx.x * kChunkPer + k] = ex;
      ex += v[k];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    counters[0] = static_cast<int>(min(total, static_cast<long long>(capacity)));
    counters[1] = static_cast<int>(max(total - capacity, 0LL));
    counters[2] = total_true == nullptr ? 0 : static_cast<int>(*total_true - total);
  }
  __syncthreads();

  // Two warps find the tile's two ends on the merge path.
  const long long items = static_cast<long long>(n) + capacity;
  const long long d0 = static_cast<long long>(blockIdx.x) * kItems;
  const long long d1 = min(d0 + kItems, items);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long i = merge_split(warp == 0 ? d0 : d1, n, capacity, local, pre, shift);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  __syncthreads();
  const long long i0 = split[0], i1 = split[1];
  const long long j0 = d0 - i0, j1 = d1 - i1;  // the tile's slots
  const long long g_lo = i0 > 0 ? i0 - 1 : 0;   // their owners lie in [g_lo, i1)
  const int m = static_cast<int>(i1 - g_lo);
  for (int k = threadIdx.x; k < m; k += kThreads) w_off[k] = offset(local, pre, shift, g_lo + k);
  __syncthreads();
  for (long long s = j0 + threadIdx.x; s < j1; s += kThreads) {
    if (s >= total) {
      tile[s] = INT_MAX;
      gid[s] = n_sentinel;
      continue;
    }
    // The last staged Gaussian with off <= s; w_off[0] <= s.
    const int si = static_cast<int>(s);
    int lo = 0, hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (w_off[mid] <= si) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long g = g_lo + lo - 1;
    const int r = si - w_off[lo - 1];
    const int b = __ldg(bbh + g);
    const int q = r / b;
    const int rem = r - q * b;
    tile[s] = __ldg(x0 + g) + q + (__ldg(y0 + g) + rem - row0) * tiles_x;
    gid[s] = __ldg(ids + g);
  }
}

}  // namespace

// Launches both kernels on the stream. chunk_sums: kMaxChunks int64
// scratch; local: [n] int32 scratch; tile, gid: [capacity] int32; counters:
// [3] int32. total_true: an int64 on the device, or null. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int tpusplat_emit(const void* ntiles, const void* x0, const void* y0,
                             const void* bbh, const void* ids, int n, const void* total_true,
                             int capacity, int tiles_x, int row0, int n_sentinel,
                             void* chunk_sums, void* local, void* tile, void* gid,
                             void* counters, void* stream) {
  int shift = kMinShift;
  while (((static_cast<long long>(n) + (1LL << shift) - 1) >> shift) > kMaxChunks) ++shift;
  const int nb = static_cast<int>((static_cast<long long>(n) + (1LL << shift) - 1) >> shift);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb > 0) {
    scan_kernel<<<nb, kThreads, 0, s>>>(static_cast<const int*>(ntiles), n, shift,
                                         static_cast<int*>(local),
                                         static_cast<long long*>(chunk_sums));
  }
  const long long tiles = (static_cast<long long>(n) + capacity + kItems - 1) / kItems;
  emit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const int*>(local), static_cast<const long long*>(chunk_sums), nb, shift,
      static_cast<const int*>(x0), static_cast<const int*>(y0), static_cast<const int*>(bbh),
      static_cast<const int*>(ids), n, static_cast<const long long*>(total_true), capacity,
      tiles_x, row0, n_sentinel, static_cast<int*>(tile), static_cast<int*>(gid),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}
