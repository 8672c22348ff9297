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
// Design: one block per tile, one thread per pixel (the reference's
// render.comp). The block stages batches of blockDim instances into shared
// memory (one coalesced load per attribute row), every thread walks the
// batch in fp32 from shared memory (broadcast reads), and
// __syncthreads_count after each batch takes the whole-tile exit.
//
// Bound: operations. Each (instance, pixel) pair costs about 13 fp32
// operations up to the alpha test (2 differences, 6 products, 2 sums, exp,
// the opacity product, the clamp): at the garden shapes (about 4.2M
// instances x 256 pixels) that is 14 GFLOP, 0.2 ms at 67 TFLOP/s, against
// 9 x 4 B x 4.2M = 151 MB of slab, 0.05 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include "blend_pair.cuh"

namespace {

constexpr int kAttrRows = 9;

__global__ void forward_kernel(const float* __restrict__ attr, long long stride,
                               const int* __restrict__ starts,
                               const int* __restrict__ ends, int tiles_x, int tile_w,
                               int tile_h, int row0, int width, int crop_h,
                               float alpha_max, float alpha_min, float t_min,
                               float* __restrict__ img, float* __restrict__ tmap) {
  extern __shared__ float batch[];  // [kAttrRows][npx]
  const int npx = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int ix = tx * tile_w + p % tile_w;  // image column
  const int iy = ty * tile_h + p / tile_w;  // row of the output (strip-local)
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(row0 * tile_h + iy);  // global pixel row
  const bool inside = ix < width && iy < crop_h;

  const int start = starts[t];
  const int end = ends[t];
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int base = start; base < end; base += npx) {
    const int cnt = min(npx, end - base);
    __syncthreads();  // the previous batch is fully consumed
    if (p < cnt) {
#pragma unroll
      for (int k = 0; k < kAttrRows; ++k) {
        batch[k * npx + p] = attr[k * stride + base + p];
      }
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const BlendPair q = blend_pair(batch[0 * npx + j], batch[1 * npx + j],
                                     batch[2 * npx + j], batch[3 * npx + j],
                                     batch[4 * npx + j], batch[5 * npx + j], px, py,
                                     alpha_max);
      if (q.power <= 0.0f && q.alpha >= alpha_min) {
        const float t_incl = T * (1.0f - q.alpha);
        if (t_incl >= t_min) {
          const float w = q.alpha * T;
          cr += batch[6 * npx + j] * w;
          cg += batch[7 * npx + j] * w;
          cb += batch[8 * npx + j] * w;
        }
        T = t_incl;
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

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpusplat_forward(const void* attr, long long stride, const void* starts,
                                const void* ends, int num_tiles, int tiles_x, int tile_w,
                                int tile_h, int row0, int width, int crop_h,
                                float alpha_max, float alpha_min, float t_min, void* img,
                                void* tmap, void* stream) {
  const int npx = tile_w * tile_h;
  const size_t smem = sizeof(float) * kAttrRows * npx;
  forward_kernel<<<num_tiles, npx, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), stride, static_cast<const int*>(starts),
      static_cast<const int*>(ends), tiles_x, tile_w, tile_h, row0, width, crop_h,
      alpha_max, alpha_min, t_min, static_cast<float*>(img), static_cast<float*>(tmap));
  return static_cast<int>(cudaGetLastError());
}
