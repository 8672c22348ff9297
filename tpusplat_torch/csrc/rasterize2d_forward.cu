// Forward ray-splat blend of depth-sorted 2D Gaussian surfels into tiles, for
// Hopper (sm_90a): 2D Gaussian Splatting's renderer (Huang et al. 2024).
//
// Replaces no TPU kernel: the JAX package renders 3D Gaussians only. Added
// so that a surfel scene (types.SurfelParams) renders and trains on the
// port's normal path. Plain version: tpusplat_torch/ops/surfel.py::
// blend2d_plain.
//
// What it computes: for each pixel of each tile_w x tile_h tile, a walk
// front to back over the tile's instances [start, end) of the slab
// attr [18, stride] (T_u, T_v, T_w, c, opacity, colour, normal): the pair
// test of surfel.cuh (the filter's term alone where the ray grazes the
// disk's plane), skipped where it fails (h_z = 0, z < near) or
// alpha < alpha_min; then, as the Gaussian blend, T_incl = T (1 - alpha),
// the pair adds with weight w = alpha T only while T_incl >= t_min, and
// T = T_incl in either case. Nine maps a pixel: colour sum w c, alpha
// A = sum w, depth sum D = sum w z, normal sum w n, and the distortion
// sum_i w_i sum_{j<i} w_j (m_i - m_j)^2, m = far / (far - near)
// (1 - near / z), from the running sums A, M1 = sum w m, M2 = sum w m^2:
// pair i adds w_i (m_i^2 A - 2 m_i M1 + M2) before they take it. Outputs:
// maps [crop_h, width, 9], the final T [crop_h, width], and the totals
// (M1, M2) [crop_h, width, 2] that the backward kernel reads. The tile stops
// once every pixel of the image in it has T == 0, which is exact.
//
// Bound: operations. Each (instance, pixel) pair the culled walk takes
// costs about 48 operations to its alpha test (k and l 6, h 9, the division
// 2, the grazing test 5, rho3 3, rho2 5, the min and exp 3, z 4, the opacity
// product, clamp and tests 4, staging shared loads not counted) and 35 more where it adds
// (weight, T, colour 6, alpha, depth 2, normal 6, m 3, the distortion 7,
// the running sums 5): splatbench/workmodel_2dgs.py counts them on the
// reference's pairs.
//
// Design: the forward Gaussian kernel's (rasterize_forward.cu): one block a
// tile, one thread a pixel, warps of 8 x 4 pixels with a per-warp cull.
// Each pass stages kBatch instances' 18 rows in shared memory, and with
// each the box of pixels at which it can reach alpha_min (surfel.cuh's
// cull_box, from its T, c and opacity); a warp votes on 32 instances' boxes
// against its rectangle and walks only those that meet it. A skipped
// instance leaves the pixel's state as it is, which is what it does to
// every pixel at which it fails the test, so the walk equals one over
// every instance up to the box's margin.

#include <cuda_runtime.h>

#include "cull.cuh"
#include "surfel.cuh"

namespace {

constexpr int kBatch = 256;  // instances staged per pass
constexpr unsigned kFull = 0xffffffffu;

// At most 256 threads a block (a 16 x 16 tile): ops/surfel.py refuses more.
// One block an SM at least: ptxas may take up to 255 registers a thread
// (capped at 80, it spilled the pixel's ray).
__global__ void __launch_bounds__(256, 1)
    forward2d_kernel(const float* __restrict__ attr, long long stride,
                     const int* __restrict__ starts, const int* __restrict__ ends,
                     const float* __restrict__ intr, int tiles_x,
                     int tile_w, int tile_h, int row0, int width, int crop_h, float alpha_max,
                     float alpha_min, float t_min, float near, float far,
                     float* __restrict__ maps, float* __restrict__ tmap,
                     float* __restrict__ msum) {
  using namespace surfel;
  __shared__ float batch[kSurfelRows * kBatch];
  __shared__ float box[4 * kBatch];
  const int npx = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  int lx, ly, x0, x1, y0, y1;
  warp_pixels(p, lane, p >> 5, tile_w, tile_h, lx, ly, x0, x1, y0, y1);
  const int ix = tx * tile_w + lx;
  const int iy = ty * tile_h + ly;
  const float px = static_cast<float>(ix);
  const float py = static_cast<float>(row0 * tile_h + iy);
  float rx, ry, graze;
  pixel_ray(intr, px, py, rx, ry, graze);
  const bool inside = ix < width && iy < crop_h;
  float wx0, wx1, wy0, wy1;
  warp_rect(tx, ty, tile_w, tile_h, row0, x0, x1, y0, y1, wx0, wx1, wy0, wy1);
  const float scale = far / (far - near);

  const int start = starts[t];
  const int end = ends[t];
  float T = 1.0f;
  float acc[kMaps];
#pragma unroll
  for (int k = 0; k < kMaps; ++k) acc[k] = 0.0f;
  float m1 = 0.0f, m2 = 0.0f;
  for (int base = start; base < end; base += kBatch) {
    const int cnt = min(kBatch, end - base);
    __syncthreads();
    for (int i = p; i < cnt; i += npx) {
      float v[12];
#pragma unroll
      for (int k = 0; k < kSurfelRows; ++k) {
        const float x = attr[k * stride + base + i];
        batch[k * kBatch + i] = x;
        if (k < 12) v[k] = x;
      }
      cull_box(v, alpha_min, box[0 * kBatch + i], box[1 * kBatch + i], box[2 * kBatch + i],
               box[3 * kBatch + i]);
    }
    __syncthreads();
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      const int jl = j0 + lane;
      const bool walk = jl < cnt && !BOX_MISSES(box, kBatch, jl, wx0, wx1, wy0, wy1);
      unsigned todo = __ballot_sync(kFull, walk);
      while (todo) {
        const int j = j0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const Pair q = pair(batch, kBatch, j, px, py, rx, ry, graze, near, alpha_max);
        if (q.ok && q.alpha >= alpha_min) {
          const float t_incl = mul(T, sub(1.0f, q.alpha));
          if (t_incl >= t_min) {
            const float w = mul(q.alpha, T);
            const float m = mul(scale, sub(1.0f, __fdiv_rn(near, q.z)));
            acc[8] = add(acc[8], mul(w, add(sub(mul(mul(m, m), acc[3]), mul(mul(2.0f, m), m1)),
                                            m2)));
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              acc[c] = add(acc[c], mul(batch[(12 + c) * kBatch + j], w));
              acc[5 + c] = add(acc[5 + c], mul(batch[(15 + c) * kBatch + j], w));
            }
            acc[3] = add(acc[3], w);
            acc[4] = add(acc[4], mul(w, q.z));
            const float wm = mul(w, m);
            m1 = add(m1, wm);
            m2 = add(m2, mul(wm, m));
          }
          T = t_incl;
        }
      }
    }
    if (__syncthreads_count(inside && T > 0.0f) == 0) break;
  }
  if (inside) {
    const long long o = static_cast<long long>(iy) * width + ix;
#pragma unroll
    for (int k = 0; k < kMaps; ++k) maps[kMaps * o + k] = acc[k];
    tmap[o] = T;
    msum[2 * o + 0] = m1;
    msum[2 * o + 1] = m2;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The tile's
// pixel count must be a multiple of 32.
extern "C" int tpusplat_forward2d(const void* attr, long long stride, const void* starts,
                                  const void* ends, const void* intr, int num_tiles,
                                  int tiles_x, int tile_w, int tile_h, int row0, int width,
                                  int crop_h, float alpha_max,
                                  float alpha_min, float t_min, float near, float far,
                                  void* maps, void* tmap, void* msum, void* stream) {
  forward2d_kernel<<<num_tiles, tile_w * tile_h, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), stride, static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float*>(intr), tiles_x, tile_w, tile_h,
      row0, width, crop_h, alpha_max,
      alpha_min, t_min, near, far, static_cast<float*>(maps), static_cast<float*>(tmap),
      static_cast<float*>(msum));
  return static_cast<int>(cudaGetLastError());
}
