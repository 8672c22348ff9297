// Backward alpha blend: per-instance gradients of the tile blend, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tpusplat/ops/rasterize_pallas.py::_backward_kernel
// (launched by _run_backward, pallas_call at rasterize_pallas.py:677, from
// _raster_core_bwd). Plain version:
// tpusplat_torch/ops/rasterize.py::backward_blend_plain (autograd of the
// plain forward blend, which recomputes the walk).
//
// What it computes: given the forward's inputs (the attribute slab
// attr [9, stride]: uv.x, uv.y, conic a, b, c, opacity, r, g, b; the tile
// ranges), its outputs (img [crop_h, width, 3], the final T tmap
// [crop_h, width]) and their cotangents (d_img, d_tmap, same layouts), it
// writes d_attr [9, stride]: for each instance slot in a tile range, the
// gradient of sum(d_img * img) + sum(d_tmap * tmap) with respect to its 9
// attributes. Per pixel, walking front to back with T the transmittance
// before the instance, f = 1 - alpha, and D = sum_c dc_c fin_c:
//   for every passing instance (power <= 0, alpha >= 1/255):
//     dalpha = -dT T_final / f
//   and if it contributes colour (T f >= 1e-4), with incl_c the colour
//   accumulated up to and including it:
//     dalpha += dc.col T - (D - dc.incl) / f,   dcol_c = alpha T dc_c
//   (D - dc.incl is the colour of everything behind it, the suffix identity
//   of rasterize_pallas.py:444-456). Through alpha = min(0.99, op e^power)
//   the gradient passes only where op e^power < 0.99; then
//   dpower = dalpha op e^power, dop = dalpha e^power, and the conic and uv
//   gradients follow from power = -0.5 (a dx^2 + c dy^2) - b dx dy.
// The masks (pass, contribute, clamp) are frozen, as autodiff of the plain
// blend freezes them. The walk reuses the forward's expression
// (blend_pair.cuh), so T is the forward's T, and stops where the forward's
// does: once every pixel of the image in the tile has T == 0, after which
// every colour term (T f < 1e-4) and every T term (T_final = 0) is exactly 0.
// Every row of [start, end) is written, with 0 past the stop; slots outside
// every range (past the last instance) are not written.
//
// Design: one block per tile, one thread per pixel, as the forward kernel.
// Each pass stages kBatch instances in shared memory. Each thread computes
// its pixel's 9 terms for one instance; each warp sums them with a fixed
// butterfly of shuffles (skipped, as zeros, where no pixel of the warp passes
// the test) and writes its partials to shared memory; after the pass, the
// threads sum each instance's per-warp partials in warp order and write the
// rows coalesced. No atomics: each instance belongs to exactly one tile, and
// the sum order is fixed, so the result is deterministic. The TPU kernel's
// 128-lane granules, boundary-granule carry and ping-pong writeback were
// workarounds for DMA stores and have no counterpart here.
//
// Bound: operations, counted per (instance, pixel) pair from the code: the
// forward's 13 operations of the test on every visited pair; 34 more on a
// passing pair (4 for f, T f, 1/f and the T term; 2 for dpower and dop; 9
// for the conic and 10 for the uv gradients; 9 adds to sum the 9 terms over
// the tile, one add a term, as any reduction needs); 16 more on a pair that
// contributes colour (its weight, the dot dc.col, the running dot, the
// suffix term and the 3 colour gradients). chip_smoke.py counts the three
// kinds of pairs of its inputs for the bound. The per-instance butterfly (45
// shuffles and adds a warp for 9 sums of 32 pixels, where 9 x 31 adds would
// do) is the cost the design adds beyond that; skipping warps with no
// passing pixel keeps it to the Gaussian's footprint.

#include <cuda_runtime.h>

#include "blend_pair.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kBatch = 128;  // instances staged per pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void backward_kernel(const float* __restrict__ attr, long long stride,
                                const int* __restrict__ starts,
                                const int* __restrict__ ends, int tiles_x, int tile_w,
                                int tile_h, int row0, int width, int crop_h,
                                float alpha_max, float alpha_min, float t_min,
                                const float* __restrict__ img,
                                const float* __restrict__ tmap,
                                const float* __restrict__ d_img,
                                const float* __restrict__ d_tmap,
                                float* __restrict__ d_attr) {
  extern __shared__ float smem[];
  float* batch = smem;                  // [kRows][kBatch] staged attributes
  float* part = smem + kRows * kBatch;  // [nwarps][kRows][kBatch] per-warp sums
  const int npx = blockDim.x;
  const int nwarps = npx >> 5;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int ix = tx * tile_w + p % tile_w;  // image column
  const int iy = ty * tile_h + p / tile_w;  // row of the output (strip-local)
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(row0 * tile_h + iy);  // global pixel row
  const bool inside = ix < width && iy < crop_h;

  // Cotangents and saved outputs; a pixel outside the crop has cotangent 0.
  float dcr = 0.0f, dcg = 0.0f, dcb = 0.0f, d_fin = 0.0f, dtf = 0.0f;
  if (inside) {
    const long long o = static_cast<long long>(iy) * width + ix;
    dcr = d_img[3 * o + 0];
    dcg = d_img[3 * o + 1];
    dcb = d_img[3 * o + 2];
    d_fin = dcr * img[3 * o + 0] + dcg * img[3 * o + 1] + dcb * img[3 * o + 2];
    dtf = -d_tmap[o] * tmap[o];
  }

  const int start = starts[t];
  const int end = ends[t];
  float T = 1.0f;
  float sdot = 0.0f;  // sum_c dc_c * (colour accumulated so far)
  int done = start;   // rows [start, done) are written
  for (int base = start; base < end; base += kBatch) {
    const int cnt = min(kBatch, end - base);
    __syncthreads();  // the previous pass's batch and partials are consumed
    for (int i = p; i < cnt; i += npx) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) batch[k * kBatch + i] = attr[k * stride + base + i];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float uvx = batch[0 * kBatch + j];
      const float uvy = batch[1 * kBatch + j];
      const float ca = batch[2 * kBatch + j];
      const float cb = batch[3 * kBatch + j];
      const float cc = batch[4 * kBatch + j];
      const BlendPair q = blend_pair(uvx, uvy, ca, cb, cc, batch[5 * kBatch + j], px, py,
                                     alpha_max);
      float g[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) g[k] = 0.0f;
      bool live = false;
      if (q.power <= 0.0f && q.alpha >= alpha_min) {
        const float f = 1.0f - q.alpha;
        const float t_incl = T * f;
        const float rf = 1.0f / f;
        float dalpha = dtf * rf;
        if (t_incl >= t_min) {
          const float w = q.alpha * T;
          const float dccol = dcr * batch[6 * kBatch + j] + dcg * batch[7 * kBatch + j] +
                              dcb * batch[8 * kBatch + j];
          sdot += w * dccol;
          dalpha += dccol * T - (d_fin - sdot) * rf;
          g[6] = w * dcr;
          g[7] = w * dcg;
          g[8] = w * dcb;
        }
        T = t_incl;
        if (q.alpha_raw < alpha_max) {
          const float dpower = dalpha * q.alpha_raw;
          g[5] = dalpha * q.epow;
          g[2] = -0.5f * q.dx * q.dx * dpower;
          g[3] = -q.dx * q.dy * dpower;
          g[4] = -0.5f * q.dy * q.dy * dpower;
          g[0] = -(ca * q.dx + cb * q.dy) * dpower;
          g[1] = -(cc * q.dy + cb * q.dx) * dpower;
        }
        live = inside;
      }
      if (__any_sync(kFull, live)) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) g[k] = warp_sum(g[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) part[(warp * kRows + k) * kBatch + j] = g[k];
      }
    }
    __syncthreads();
    for (int i = p; i < kRows * cnt; i += npx) {
      const int k = i / cnt;
      const int j = i - k * cnt;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += part[(w * kRows + k) * kBatch + j];
      d_attr[k * stride + base + j] = s;
    }
    done = base + cnt;
    if (__syncthreads_count(inside && T > 0.0f) == 0) break;
  }
  // Past the stop every term is exactly 0.
  for (int i = done + p; i < end; i += npx) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) d_attr[k * stride + i] = 0.0f;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The tile's
// pixel count must be a multiple of 32.
extern "C" int tpusplat_backward(const void* attr, long long stride, const void* starts,
                                 const void* ends, int num_tiles, int tiles_x, int tile_w,
                                 int tile_h, int row0, int width, int crop_h,
                                 float alpha_max, float alpha_min, float t_min,
                                 const void* img, const void* tmap, const void* d_img,
                                 const void* d_tmap, void* d_attr, void* stream) {
  const int npx = tile_w * tile_h;
  const size_t smem = sizeof(float) * kRows * kBatch * (1 + npx / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  backward_kernel<<<num_tiles, npx, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), stride, static_cast<const int*>(starts),
      static_cast<const int*>(ends), tiles_x, tile_w, tile_h, row0, width, crop_h,
      alpha_max, alpha_min, t_min, static_cast<const float*>(img),
      static_cast<const float*>(tmap), static_cast<const float*>(d_img),
      static_cast<const float*>(d_tmap), static_cast<float*>(d_attr));
  return static_cast<int>(cudaGetLastError());
}
