// Instance emission for tile binning, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusplat/ops/emission.py::_emission_kernel
// (launched by expand_instances_pallas, pallas_call at emission.py:294).
// Plain version: tpusplat_torch/ops/binning.py::expand_instances_sorted.
//
// What it computes, per instance slot s in [0, capacity): the owner g is
// the last Gaussian in depth-emission order with off[g] <= s (off = the
// exclusive cumsum of the tile counts; zero-count Gaussians share their
// successor's off and are never the last). With r = s - off[g]:
//   tile[s] = x0[g] + r / bbh[g] + (y0[g] + r % bbh[g] - row0) * tiles_x
//   gid[s]  = ids[g]
// (x outer, y inner, the reference's preprocess_sort.comp:47-48). Slots at
// or past min(total, capacity) get (INT32_MAX, n_sentinel).
//
// Design: one thread per slot, a binary search over off, then plain integer
// division. This is load-balanced where one thread per Gaussian is not (a
// large Gaussian covers hundreds of tiles). The TPU kernel's workarounds do
// not carry over: Hopper has integer division and scattered stores, so
// there is no 8/8/8-bit packed meta and no 255-tile-row limit, no
// telescoping matmul for the owner lookup, and no float reciprocal.
//
// Bound: memory. Each slot writes two int32 (8 B); the five [N] int32 meta
// arrays are read once (the binary search stays in L2: off is 4 B * N,
// 5.6 MB at 1.4M Gaussians). At the garden shapes (about 4.2M slots) that
// is a few tens of MB, some tens of microseconds at 3.35 TB/s.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

__global__ void emission_kernel(const int* __restrict__ off, const int* __restrict__ x0,
                                const int* __restrict__ y0, const int* __restrict__ bbh,
                                const int* __restrict__ ids, int n,
                                const long long* __restrict__ total_ptr, int capacity,
                                int tiles_x, int row0, int n_sentinel,
                                int* __restrict__ tile, int* __restrict__ gid) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= capacity) return;
  if (static_cast<long long>(s) >= *total_ptr) {
    tile[s] = INT_MAX;
    gid[s] = n_sentinel;
    return;
  }
  // upper_bound: first index with off > s; off[0] == 0 <= s, so g >= 0.
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo - 1;
  const int r = s - __ldg(off + g);
  const int b = __ldg(bbh + g);
  const int q = r / b;
  const int rem = r - q * b;
  tile[s] = __ldg(x0 + g) + q + (__ldg(y0 + g) + rem - row0) * tiles_x;
  gid[s] = __ldg(ids + g);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpusplat_emission(const void* off, const void* x0, const void* y0,
                                 const void* bbh, const void* ids, int n,
                                 const void* total, int capacity, int tiles_x, int row0,
                                 int n_sentinel, void* tile, void* gid, void* stream) {
  const int blocks = (capacity + kThreads - 1) / kThreads;
  emission_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(off), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<const int*>(bbh),
      static_cast<const int*>(ids), n, static_cast<const long long*>(total), capacity,
      tiles_x, row0, n_sentinel, static_cast<int*>(tile), static_cast<int*>(gid));
  return static_cast<int>(cudaGetLastError());
}
