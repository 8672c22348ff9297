// Backward ray-splat blend of 2D Gaussian surfels: per-instance gradients of
// the surfel blend's nine maps and its transmittance, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package renders 3D Gaussians only. Added
// with rasterize2d_forward.cu, whose outputs it takes. Plain version:
// tpusplat_torch/ops/surfel.py::backward2d_plain (autograd of the plain
// forward blend, which recomputes the walk).
//
// What it computes: from the slab attr [18, stride], the tile ranges, the
// forward's maps [crop_h, width, 9], final T and totals (M1, M2), and the
// cotangents d_maps and d_tmap, it writes d_attr [18, stride]: for each
// instance slot in a tile range the gradient of sum(d_maps * maps) +
// sum(d_tmap * tmap) with respect to its 18 rows. Per pixel, front to back,
// with T the transmittance before a pair and f = 1 - alpha, a pair that
// adds (weight w = alpha T) has the cotangent of its weight
//   G = dc . c + dA + dD z + dN . n + dL (m^2 A - 2 m M1 + M2)
// (A, M1, M2 the pixel's totals: the distortion is (1/2) sum_ij w_i w_j
// (m_i - m_j)^2, so d L / d w_k = sum_j w_j (m_k - m_j)^2), and
//   d alpha = G T - (S - s) / f - dT T_final / f
// where s sums G w over the pairs up to this one and S over all of them:
// S = dc . C + dA A + dD D + dN . N + 2 dL L (L homogeneous of degree 2 in
// the weights), from the forward's maps; a pair that passes without adding
// keeps only the last two terms. Its depth gets dz = w (dD + 2 dL (m A -
// M1) dm/dz). Through alpha = min(alpha_max, op G) (passing where op G <
// alpha_max), G = exp(-rho / 2) with rho the lesser of rho3 = u^2 + v^2 and
// rho2 = 2 |x - c|^2 (rho3 +inf where the ray grazes the disk's plane),
// z = T_w . (u, v, 1) where rho3 <= rho2 (else the centre's T_w,z,
// surfel.cuh), (u, v) = (h_x, h_y) / h_z and
// h = k x l: d k = l x d h, d l = d h x k, and with k = x T_w - T_u,
// l = y T_w - T_v the rows of T. The masks (pass, add, clamp, which of rho3
// and rho2) are frozen, as autodiff of the plain blend freezes them. The
// walk reuses surfel.cuh's pair, whose every operation is rounded on its
// own, so T is the forward's T bit for bit, and stops where the forward's
// does. Every row of [start, end) is written, 0 past the stop.
//
// Bound: operations: the forward's 48 a pair the culled walk takes, and
// about 120 more where a pair adds (G 14, d alpha 6, dz 8, the clamp and
// exp 4, rho 4, u and v 10, h 6, k and l 30, the T rows 18, and the 18
// sums over the tile): splatbench/workmodel_2dgs.py counts them.
//
// Design: the Gaussian backward kernel's (rasterize_backward.cu): one block
// a tile, one thread a pixel, its warps' layout and per-warp cull; where any
// lane of a warp passes an instance, the warp sums the 18 terms by a
// transposed reduction (20 shuffles: at each of five steps a lane keeps
// half of its values and sends its partner the other half) into per-warp
// partials in shared memory, which the block then adds in warp order and
// writes coalesced. No atomics: the result is the same from launch to
// launch.

#include <cuda_runtime.h>

#include "cull.cuh"
#include "surfel.cuh"

namespace {

constexpr int kRows = kSurfelRows;
constexpr int kBatch = 128;  // instances staged per pass
constexpr int kWords = kBatch / 32;
constexpr unsigned kFull = 0xffffffffu;

// One step of the transposed reduction: v[0, m) becomes v[0, (m + 1) / 2);
// the upper lane of each pair (lane ^ o) keeps the upper half (zeros past
// m), the lower lane the lower half, and each adds the half its partner
// sends.
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

// Sums each of the 18 values v over the warp's 32 lanes in 20 shuffles.
// Returns the sum the lane holds, with *row set to which of the 18 it is,
// or to -1 where the lane holds padding.
__device__ __forceinline__ float warp_sum18(float (&v)[kRows], int lane, int* row) {
  keep_half<18>(v, 16, lane & 16);
  keep_half<9>(v, 8, lane & 8);
  keep_half<5>(v, 4, lane & 4);
  keep_half<3>(v, 2, lane & 2);
  keep_half<2>(v, 1, lane & 1);
  // Which of the 18 the lane holds: at each step (bit 16, 8, 4, 2, 1 of
  // the lane) the upper half [s + h, ...) or the lower [s, s + h), h = 9,
  // 5, 3, 2, 1; c counts the real values left.
  int s = 0, c = kRows;
  int h = 9;
#pragma unroll
  for (int bit = 16; bit > 0; bit >>= 1) {
    if (lane & bit) {
      s += h;
      c -= h;
    } else {
      c = min(c, h);
    }
    h = (h + 1) / 2;
  }
  *row = c > 0 ? s : -1;
  return v[0];
}

// At most 256 threads a block, one block an SM at least: ptxas may take up
// to 255 registers a thread (capped lower, it spilled).
__global__ void __launch_bounds__(256, 1)
    backward2d_kernel(const float* __restrict__ attr, long long stride,
                      const int* __restrict__ starts, const int* __restrict__ ends,
                      const float* __restrict__ intr, int tiles_x, int tile_w, int tile_h,
                      int row0, int width, int crop_h,
                      float alpha_max, float alpha_min, float t_min, float near, float far,
                      const float* __restrict__ maps, const float* __restrict__ tmap,
                      const float* __restrict__ msum, const float* __restrict__ d_maps,
                      const float* __restrict__ d_tmap, float* __restrict__ d_attr) {
  using namespace surfel;
  extern __shared__ float smem[];
  const int npx = blockDim.x;
  const int nwarps = npx >> 5;
  float* batch = smem;                  // [kRows][kBatch]
  float* box = batch + kRows * kBatch;  // [4][kBatch]
  float* part = box + 4 * kBatch;       // [nwarps][kBatch][kRows]
  unsigned* live = reinterpret_cast<unsigned*>(part + nwarps * kBatch * kRows);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  int lx, ly, x0, x1, y0, y1;
  warp_pixels(p, lane, warp, tile_w, tile_h, lx, ly, x0, x1, y0, y1);
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

  // The pixel's cotangents and totals; a pixel outside the crop has none.
  float dc0 = 0.0f, dc1 = 0.0f, dc2 = 0.0f, dn0 = 0.0f, dn1 = 0.0f, dn2 = 0.0f;
  float dA = 0.0f, dD = 0.0f, dL = 0.0f, dtf = 0.0f, total = 0.0f;
  float a_tot = 0.0f, m1 = 0.0f, m2 = 0.0f;
  if (inside) {
    const long long o = static_cast<long long>(iy) * width + ix;
    const float* g = d_maps + kMaps * o;
    const float* f = maps + kMaps * o;
    dc0 = g[0];
    dc1 = g[1];
    dc2 = g[2];
    dn0 = g[5];
    dn1 = g[6];
    dn2 = g[7];
    dA = g[3];
    dD = g[4];
    dL = g[8];
    total = dc0 * f[0] + dc1 * f[1] + dc2 * f[2] + dA * f[3] + dD * f[4] + dn0 * f[5] +
            dn1 * f[6] + dn2 * f[7] + 2.0f * dL * f[8];
    a_tot = f[3];
    m1 = msum[2 * o + 0];
    m2 = msum[2 * o + 1];
    dtf = -d_tmap[o] * tmap[o];
  }

  const int start = starts[t];
  const int end = ends[t];
  float T = 1.0f;
  float sdot = 0.0f;  // sum of G w over the pairs walked so far
  int done = start;
  for (int base = start; base < end; base += kBatch) {
    const int cnt = min(kBatch, end - base);
    __syncthreads();
    for (int i = p; i < cnt; i += npx) {
      float v[12];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
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
      unsigned live_bits = 0;
      while (todo) {
        const int jb = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = j0 + jb;
        const Pair q = pair(batch, kBatch, j, px, py, rx, ry, graze, near, alpha_max);
        float g[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) g[k] = 0.0f;
        bool pixel_live = false;
        if (q.ok && q.alpha >= alpha_min) {
          const float f = sub(1.0f, q.alpha);
          const float t_incl = mul(T, f);
          const float rf = 1.0f / f;
          float dalpha = dtf * rf;
          float dz = 0.0f;
          if (t_incl >= t_min) {
            const float w = mul(q.alpha, T);
            const float m = mul(scale, sub(1.0f, __fdiv_rn(near, q.z)));
            const float gk = dA + dD * q.z + dL * (m * m * a_tot - 2.0f * m * m1 + m2) +
                             dc0 * batch[12 * kBatch + j] + dc1 * batch[13 * kBatch + j] +
                             dc2 * batch[14 * kBatch + j] + dn0 * batch[15 * kBatch + j] +
                             dn1 * batch[16 * kBatch + j] + dn2 * batch[17 * kBatch + j];
            g[12] = w * dc0;
            g[13] = w * dc1;
            g[14] = w * dc2;
            g[15] = w * dn0;
            g[16] = w * dn1;
            g[17] = w * dn2;
            sdot += w * gk;
            dalpha += gk * T - (total - sdot) * rf;
            const float zi = 1.0f / q.z;
            dz = w * (dD + 2.0f * dL * (m * a_tot - m1) * scale * near * zi * zi);
          }
          T = t_incl;
          float drho = 0.0f;
          if (q.alpha_raw < alpha_max) {
            g[11] = dalpha * q.g;
            drho = -0.5f * dalpha * q.alpha_raw;
          }
          const float drho3 = q.use3 ? drho : 0.0f;
          const float drho2 = q.use3 ? 0.0f : drho;
          g[9] = 4.0f * (batch[9 * kBatch + j] - px) * drho2;
          g[10] = 4.0f * (batch[10 * kBatch + j] - py) * drho2;
          // z = T_w . (u, v, 1) where the disk's term wins, else T_w,z.
          const float dzi = q.use3 ? dz : 0.0f;
          const float tw0 = batch[6 * kBatch + j], tw1 = batch[7 * kBatch + j];
          const float du = 2.0f * q.u * drho3 + tw0 * dzi;
          const float dv = 2.0f * q.v * drho3 + tw1 * dzi;
          const float rhz = 1.0f / q.hz;
          const float dhx = du * rhz, dhy = dv * rhz;
          const float dhz = -(du * q.u + dv * q.v) * rhz;
          const float dkx = q.ly * dhz - q.lz * dhy;
          const float dky = q.lz * dhx - q.lx * dhz;
          const float dkz = q.lx * dhy - q.ly * dhx;
          const float dlx = dhy * q.kz - dhz * q.ky;
          const float dly = dhz * q.kx - dhx * q.kz;
          const float dlz = dhx * q.ky - dhy * q.kx;
          g[0] = -dkx;
          g[1] = -dky;
          g[2] = -dkz;
          g[3] = -dlx;
          g[4] = -dly;
          g[5] = -dlz;
          g[6] = q.u * dzi + px * dkx + py * dlx;
          g[7] = q.v * dzi + px * dky + py * dly;
          g[8] = dz + px * dkz + py * dlz;
          pixel_live = inside;
        }
        if (__any_sync(kFull, pixel_live)) {
          int row;
          const float sum = warp_sum18(g, lane, &row);
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
        if (live[w * kWords + (j >> 5)] >> (j & 31) & 1u) s += part[(w * kBatch + j) * kRows + k];
      }
      d_attr[k * stride + base + j] = s;
    }
    done = base + cnt;
    if (__syncthreads_count(inside && T > 0.0f) == 0) break;
  }
  for (int i = done + p; i < end; i += npx) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) d_attr[k * stride + i] = 0.0f;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The tile's
// pixel count must be a multiple of 32, at most 256.
extern "C" int tpusplat_backward2d(const void* attr, long long stride, const void* starts,
                                   const void* ends, const void* intr, int num_tiles,
                                   int tiles_x, int tile_w, int tile_h, int row0, int width,
                                   int crop_h,
                                   float alpha_max, float alpha_min, float t_min, float near,
                                   float far, const void* maps, const void* tmap,
                                   const void* msum, const void* d_maps, const void* d_tmap,
                                   void* d_attr, void* stream) {
  const int npx = tile_w * tile_h;
  const int nwarps = npx / 32;
  const size_t smem = sizeof(float) * kBatch * (kRows + 4 + nwarps * kRows) +
                      sizeof(unsigned) * nwarps * kWords;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  backward2d_kernel<<<num_tiles, npx, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attr), stride, static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float*>(intr), tiles_x, tile_w, tile_h,
      row0, width, crop_h, alpha_max,
      alpha_min, t_min, near, far, static_cast<const float*>(maps),
      static_cast<const float*>(tmap), static_cast<const float*>(msum),
      static_cast<const float*>(d_maps), static_cast<const float*>(d_tmap),
      static_cast<float*>(d_attr));
  return static_cast<int>(cudaGetLastError());
}
