// Forward alpha blend of depth-sorted instances into tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusplat/ops/rasterize_pallas.py::_forward_kernel
// (launched by _run_forward, pallas_call at rasterize_pallas.py:634, via
// _raster_core from rasterize_pallas). Plain version:
// tpusplat_torch/ops/rasterize.py::blend_plain (ported from
// tpusplat/ops/rasterize_xla.py).
//
// What it computes: for each pixel of each tile_w x tile_h tile, a walk
// front to back over the tile's instances [start, end) of the attribute
// slab attr [9, stride] (rows: uv.x, uv.y, conic a, b, c, opacity, r, g, b):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op e^power)
//   skip the instance if power > 0 or alpha < 1/255;
//   T_incl = T (1 - alpha); the colour gets alpha * T only while
//   T_incl >= 1e-4 (checked before the add); T = T_incl in either case.
// The final T is thus the product of (1 - alpha) over every passing
// instance the walk visits, also after the pixel stopped contributing, as
// in the JAX package (rasterize_xla.py:75-82, rasterize_pallas.py:209-217).
// The whole tile stops early only once every pixel of the image in the
// tile has T == 0, where every later product stays 0 and adds no colour, so
// the exit is exact. (The TPU kernel exits once every T < 1e-4,
// rasterize_pallas.py:284-286; that leaves a saturated pixel's final T up to
// 1e-4 above the full product, measured 9e-5 at the garden shapes, outside
// the 3e-5 bound against the plain version.)
// Output: img [crop_h, width, 3] and the final T [crop_h, width], written
// directly in image layout (no [tiles, 8, 256] intermediate).
//
// Bound: operations, as counted. Each (instance, pixel) pair costs about 13
// fp32 operations up to the alpha test (2 differences, 6 products, 2 sums,
// exp, the opacity product, the clamp), on the 32 pixels of each (instance,
// warp) pair the culled walk must take (the box meets the warp, and some
// pixel of the warp still has T > 0): chip_smoke.py counts those pairs of
// its inputs, against 9 x 4 B of slab an instance and the image and T.
// What costs is not those operations but the warp instructions issued for
// pairs that fail the test: about 86% of the pairs of an unculled walk
// fail at the garden shapes, and a warp that walks an instance pays its
// shared loads, the exp and the test on all 32 lanes whether or not any
// lane passes.
//
// Design: one block per tile, one thread per pixel (the reference's
// render.comp), with the backward kernel's warps and per-warp cull
// (cull.cuh): a warp's pixels are an 8 x 4 block of the tile where the tile
// divides into them. Each pass stages kBatch instances in shared memory,
// and with each the box of pixels at which it can pass the test. Each warp
// takes the batch 32 instances at a time: one vote of its lanes, lane i
// testing instance i's box against the rectangle of the warp's pixels,
// leaves the instances the warp must walk, and it walks only those, in
// order. A warp that skips an instance leaves T and the colour as they
// are, which is what the instance does to every pixel at which it fails
// the test, so the image and T are bit-equal to a walk over every
// instance, and the backward kernel, which walks the same way, recomputes
// the same T. __syncthreads_count after each pass takes the whole-tile
// exit. The walk waits on its dependent chain (shared loads, exp, the
// T update), so the blocks an SM holds set the pace, and registers limit
// them: capped at 64 a thread (__launch_bounds__(1024)) the kernel takes
// 50 and an SM holds five tiles. Tried on the card and not kept, as none
// was faster in turns: the attributes staged as two float4 per instance,
// a warp's stop once its pixels all have T == 0, and loading the next
// batch into registers during the walk.

#include <cuda_runtime.h>

#include "blend_pair.cuh"
#include "cull.cuh"

namespace {

constexpr int kAttrRows = 9;
constexpr int kBatch = 256;  // instances staged per pass
constexpr unsigned kFull = 0xffffffffu;

// At most 1024 threads a block, so at most 64 registers a thread (see the
// note above).
__global__ void __launch_bounds__(1024)
    forward_kernel(const float* __restrict__ attr, long long stride,
                   const int* __restrict__ starts, const int* __restrict__ ends, int tiles_x,
                   int tile_w, int tile_h, int row0, int width, int crop_h, float alpha_max,
                   float alpha_min, float t_min, float* __restrict__ img,
                   float* __restrict__ tmap) {
  __shared__ float batch[kAttrRows * kBatch];  // the staged attributes, by row
  __shared__ float box[4 * kBatch];            // x lo, x hi, y lo, y hi of passing
  const int npx = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  // The thread's pixel and its warp's rectangle (cull.cuh).
  int lx, ly, x0, x1, y0, y1;
  warp_pixels(p, lane, p >> 5, tile_w, tile_h, lx, ly, x0, x1, y0, y1);
  const int ix = tx * tile_w + lx;  // image column
  const int iy = ty * tile_h + ly;  // row of the output (strip-local)
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(row0 * tile_h + iy);  // global pixel row
  const bool inside = ix < width && iy < crop_h;
  float wx0, wx1, wy0, wy1;
  warp_rect(tx, ty, tile_w, tile_h, row0, x0, x1, y0, y1, wx0, wx1, wy0, wy1);

  const int start = starts[t];
  const int end = ends[t];
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int base = start; base < end; base += kBatch) {
    const int cnt = min(kBatch, end - base);
    __syncthreads();  // the previous batch is fully consumed
    for (int i = p; i < cnt; i += npx) {
      float v[kAttrRows];
#pragma unroll
      for (int k = 0; k < kAttrRows; ++k) v[k] = attr[k * stride + base + i];
#pragma unroll
      for (int k = 0; k < kAttrRows; ++k) batch[k * kBatch + i] = v[k];
      const float2 h = pass_extent(v[2], v[3], v[4], v[5], alpha_min);
      box[0 * kBatch + i] = v[0] - h.x;
      box[1 * kBatch + i] = v[0] + h.x;
      box[2 * kBatch + i] = v[1] - h.y;
      box[3 * kBatch + i] = v[1] + h.y;
    }
    __syncthreads();
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const int jl = j0 + lane;
      const bool walk = jl < cnt && !BOX_MISSES(box, kBatch, jl, wx0, wx1, wy0, wy1);
      unsigned todo = __ballot_sync(kFull, walk);
      while (todo) {
        const int j = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const BlendPair q = blend_pair(batch[0 * kBatch + j], batch[1 * kBatch + j],
                                       batch[2 * kBatch + j], batch[3 * kBatch + j],
                                       batch[4 * kBatch + j], batch[5 * kBatch + j], px, py,
                                       alpha_max);
        if (q.power <= 0.0f && q.alpha >= alpha_min) {
          const float t_incl = T * (1.0f - q.alpha);
          if (t_incl >= t_min) {
            const float w = q.alpha * T;
            cr += batch[6 * kBatch + j] * w;
            cg += batch[7 * kBatch + j] * w;
            cb += batch[8 * kBatch + j] * w;
          }
          T = t_incl;
        }
      }
    }
    if (__syncthreads_count(inside && T > 0.0f) == 0) break;
  }
  if (inside) {
    const long long o = static_cast<long long>(iy) * width + ix;
    img[3 * o + 0] = cr;
    img[3 * o + 1] = cg;
    img[3 * o + 2] = cb;
    tmap[o] = T;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The tile's
// pixel count must be a multiple of 32.
extern "C" int tpusplat_forward(const void* attr, long long stride, const void* starts,
                                const void* ends, int num_tiles, int tiles_x, int tile_w,
                                int tile_h, int row0, int width, int crop_h,
                                float alpha_max, float alpha_min, float t_min, void* img,
                                void* tmap, void* stream) {
  const int npx = tile_w * tile_h;
  forward_kernel<<<num_tiles, npx, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), stride, static_cast<const int*>(starts),
      static_cast<const int*>(ends), tiles_x, tile_w, tile_h, row0, width, crop_h,
      alpha_max, alpha_min, t_min, static_cast<float*>(img), static_cast<float*>(tmap));
  return static_cast<int>(cudaGetLastError());
}
