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
// of rasterize_pallas.py:444-456). Through alpha = min(0.99, op e^power)
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
// Bound: operations, counted per (instance, pixel) pair from the code: the
// forward's 13 operations of the test on the 32 pixels of each (instance,
// warp) pair the culled walk must take (see rasterize_forward.cu); 34 more
// on a passing pair (4 for f, T f, 1/f and the T term; 2 for dpower and dop;
// 9 for the conic and 10 for the uv gradients; 9 adds to sum the 9 terms
// over the tile, one add a term, as any reduction needs); 16 more on a pair
// that contributes colour (its weight, the dot dc.col, the running dot, the
// suffix term and the 3 colour gradients). chip_smoke.py counts the three
// kinds of pairs of its inputs for the bound. What costs is not these
// operations but the warp instructions issued for pairs that fail the test:
// at the garden shapes about 86% of the pairs of an unculled walk fail,
// and a warp that walks an instance pays the exp, the vote and the sums of its 32 lanes
// whether or not any lane passes.
//
// Design: one block per tile, one thread per pixel, as the forward kernel,
// with its warps' pixel layout and per-warp cull (cull.cuh, whose note
// holds the cull's float32 argument). Each pass stages kBatch instances in
// shared memory, and with each the box of pixels at which it can pass the
// test. Each warp takes the batch 32 instances at a time: one vote of its
// lanes, lane i testing instance i's box against the rectangle of the
// warp's pixels, leaves the instances the warp must walk, and it walks only
// those, in order. For each, every thread computes its pixel's 9 terms;
// where any lane passes, the warp sums the 9 terms by a transposed
// reduction (at each step a lane keeps half of its values and sends the
// other half to its partner: 12 shuffles for 9 sums, where 9 butterflies
// take 45), after which 9 lanes hold the 9 sums and store them to shared
// memory together, and the warp sets the instance's bit in its live mask.
// After the pass, the threads sum each instance's partials over the warps
// whose bit is set, in warp order, and write the rows coalesced. No
// atomics: each instance belongs to exactly one tile, and the sum order is
// fixed, so the result is deterministic. A warp that skips an instance
// leaves T and the running dot as they are, which is what the instance
// does to them when no pixel of the warp passes. The TPU kernel's 128-lane
// granules, boundary-granule carry and ping-pong writeback were workarounds
// for DMA stores and have no counterpart here.

#include <cuda_runtime.h>

#include "blend_pair.cuh"
#include "cull.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kBatch = 128;  // instances staged per pass
constexpr int kWords = kBatch / 32;
constexpr unsigned kFull = 0xffffffffu;
// One step of the transposed reduction: v[0, m) becomes v[0, h), h = (m+1)/2.
// The upper lane of each pair (lane ^ o) keeps v[h, m) (and zeros past m),
// the lower keeps v[0, h), and each adds the half its partner sends.
template <int M>
__device__ __forceinline__ void keep_half(float (&v)[kRows], int o, bool upper) {
  constexpr int H = (M + 1) / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < M ? v[i + H] : 0.0f;
    v[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, o);
  }
}

// Sums each of the 9 values v over the warp's 32 lanes in 12 shuffles.
// Returns the sum the lane holds, with *row set to which of the 9 it is, or
// to -1 where the lane holds padding or is the upper lane of a pair (lanes
// l and l ^ 1 hold the same sum; the lower one reports it).
__device__ __forceinline__ float warp_sum9(float (&v)[kRows], int lane, int* row) {
  keep_half<9>(v, 16, lane & 16);
  keep_half<5>(v, 8, lane & 8);
  keep_half<3>(v, 4, lane & 4);
  keep_half<2>(v, 2, lane & 2);
  v[0] += __shfl_xor_sync(kFull, v[0], 1);
  // Which of the 9 the lane holds: the kept halves, [s, s + c) of them real.
  int s = 0, c = kRows;
  const int bits[4] = {16, 8, 4, 2};
  const int halves[4] = {5, 3, 2, 1};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (lane & bits[i]) {
      s += halves[i];
      c -= halves[i];
    } else {
      c = min(c, halves[i]);
    }
  }
  *row = (c > 0 && !(lane & 1)) ? s : -1;
  return v[0];
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
  const int npx = blockDim.x;
  const int nwarps = npx >> 5;
  float* batch = smem;                  // [kRows][kBatch] staged attributes
  float* box = batch + kRows * kBatch;  // [4][kBatch] x lo, x hi, y lo, y hi of passing
  float* part = box + 4 * kBatch;       // [nwarps][kBatch][kRows] per-warp sums
  unsigned* live = reinterpret_cast<unsigned*>(part + nwarps * kBatch * kRows);
  // live: [nwarps][kWords], bit j: the warp wrote partials for instance j
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  // The thread's pixel and its warp's rectangle (cull.cuh).
  int lx, ly, x0, x1, y0, y1;
  warp_pixels(p, lane, warp, tile_w, tile_h, lx, ly, x0, x1, y0, y1);
  const int ix = tx * tile_w + lx;  // image column
  const int iy = ty * tile_h + ly;  // row of the output (strip-local)
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(row0 * tile_h + iy);  // global pixel row
  const bool inside = ix < width && iy < crop_h;
  float wx0, wx1, wy0, wy1;
  warp_rect(tx, ty, tile_w, tile_h, row0, x0, x1, y0, y1, wx0, wx1, wy0, wy1);

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
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        v[k] = attr[k * stride + base + i];
        batch[k * kBatch + i] = v[k];
      }
      const float2 h = pass_extent(v[2], v[3], v[4], v[5], alpha_min);
      box[0 * kBatch + i] = v[0] - h.x;
      box[1 * kBatch + i] = v[0] + h.x;
      box[2 * kBatch + i] = v[1] - h.y;
      box[3 * kBatch + i] = v[1] + h.y;
    }
    __syncthreads();
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const int jl = j0 + lane;
      // Walked where the box meets the rectangle; a NaN edge culls nothing.
      const bool walk = jl < cnt && !BOX_MISSES(box, kBatch, jl, wx0, wx1, wy0, wy1);
      unsigned todo = __ballot_sync(kFull, walk);
      unsigned live_bits = 0;
      while (todo) {
        const int jb = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = j0 + jb;
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
        bool pixel_live = false;
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
          pixel_live = inside;
        }
        if (__any_sync(kFull, pixel_live)) {
          int row;
          const float sum = warp_sum9(g, lane, &row);
          if (row >= 0) part[(warp * kBatch + j) * kRows + row] = sum;
          live_bits |= 1u << jb;
        }
      }
      if (lane == 0) live[warp * kWords + (j0 >> 5)] = live_bits;
    }
    __syncthreads();
    for (int i = p; i < kRows * cnt; i += npx) {
      const int k = i / cnt;
      const int j = i - k * cnt;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        if (live[w * kWords + (j >> 5)] >> (j & 31) & 1u) {
          s += part[(w * kBatch + j) * kRows + k];
        }
      }
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
  const int nwarps = npx / 32;
  const size_t smem = sizeof(float) * kBatch * (kRows + 4 + nwarps * kRows) +
                      sizeof(unsigned) * nwarps * kWords;
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
