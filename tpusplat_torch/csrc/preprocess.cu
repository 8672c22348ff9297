// Per-Gaussian preprocess for one camera, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes preprocess outside
// Pallas (tpusplat/ops/preprocess.py, elementwise jnp that XLA fuses). It
// was added because the port's plain version of it on the card,
// tpusplat_torch/ops/preprocess.py::preprocess_plain, is some 150
// elementwise kernels and four torch.stack copies, about 30x its byte
// bound. That plain version stays the route of every call that records a
// gradient (this kernel has no backward) and of the CPU, and the yardstick
// chip_smoke.py holds this kernel to.
//
// What it computes: the whole of preprocess_plain for the Gaussians
// [0, n), one thread a Gaussian: the view and clip transforms and the
// z <= z_near_cull cull; the EWA Jacobian with its 1.3 tan_fov clamp; the
// 3D covariance from exp(log_scales) * scale_modifier and the normalised
// quaternion; the 2D covariance with the dilation, the det <= 0 cull and
// the conic; the radius (the eigenvalue one, or the opacity-aware
// tight_radius one); ndc2Pix, the tile box and ntiles; the alive mask; the
// SH colour at degree 0-3 with the red, all or none clamp. Every output is
// defined for every Gaussian, culled ones included, exactly as the plain
// version defines it.
//
// Bound: bytes. A Gaussian reads 237 B at SH degree 3 (means 12,
// log_scales 12, quats 16, opacity 4, SH 192, alive 1) and writes 64
// (aabb 16, uv 8, conic 12, opacity 4, color 12, depth 4, radius 4,
// ntiles 4): at garden's 1.4M Gaussians 0.42 GB, 0.126 ms at 3.35 TB/s;
// its 389 float operations a Gaussian would take 8 us at 67 TFLOP/s.
//
// Design:
//  * The SH row is 192 contiguous bytes (16 coefficients x RGB), and only
//    the float4s that the degree needs are read. The block copies its
//    Gaussians' rows into shared memory with coalesced 16-byte cp.async
//    copies, issued with every other load before any arithmetic, each row
//    padded to an odd number of float4s so that a thread's 16-byte reads
//    of its own row meet no bank conflict. That measured 3% faster than
//    each thread reading its own row with 16-byte loads (garden 0.145
//    against 0.150 ms, bicycle 0.597 against 0.620 on an H100). quats are
//    one 16-byte load. The wrapper checks that both arrays are 16-byte
//    aligned and contiguous.
//  * The camera (view, proj, cam_pos, tan_fovx, tan_fovy) is read from
//    device memory, once a block, into shared memory: a CUDA graph replay
//    then sees each frame's camera, which the graph's static buffers hold.
//    The frame size and the RenderConfig fields are arguments, as they are
//    part of a compiled render's key.
//  * Outputs go to one buffer of 16 words a Gaussian, field by field:
//    aabb first ([n, 4] int32, so its int4 stores are 16-byte aligned for
//    any n), then the blend's [9, n] attribute table (the rows uv x, uv y,
//    conic a, b, c, opacity, color r, g, b), then depth, radius and ntiles,
//    every store coalesced. The wrapper hands out each field as a view of
//    it, and the blend's pack_instances gathers from the table as it lies
//    (ops/preprocess.py::attribute_table), where the plain version's
//    fields are concatenated first. Nothing in between reaches device
//    memory.
//  * Rounding: the plain version rounds after every elementwise op, so the
//    arithmetic here runs in its order with __fmul_rn / __fadd_rn /
//    __fsub_rn, which nvcc never contracts into FMAs, IEEE division and
//    reciprocal, sqrtf, and the same library functions PyTorch's kernels
//    call (expf, logf, rsqrtf, ceilf, floorf). A Python scalar is rounded
//    to float before it meets a tensor, as PyTorch rounds it; `s / t` for
//    a tensor t is `t.reciprocal() * s` (Tensor.__rtruediv__); a division
//    by a Python scalar is a product with its float reciprocal (PyTorch's
//    div_true for a CPU scalar). The three sums the plain version takes
//    with torch.sum are taken in the order of PyTorch's reduce kernel:
//    ((q0^2 + q2^2) + (q1^2 + q3^2)) for the quaternion, ((d0^2 + d2^2) +
//    d1^2) for the view direction, and the SH sum in four interleaved
//    accumulators. So the culls, radius, aabb and ntiles come out equal to
//    the plain version's on the card bit for bit (chip_smoke.py's
//    preprocess phase holds them to it), without a global -fmad=false that
//    would change the other kernels' builds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kCamFloats = 16 + 16 + 3 + 2;  // view, proj, cam_pos, tan_fovx, tan_fovy

// tpusplat_torch/config.py's SH_C0..SH_C3, and the plain version's other
// Python float scalars, each rounded to float as PyTorch rounds a scalar
// operand.
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);
constexpr float kClampFov = static_cast<float>(1.3);
constexpr float kLamFloor = static_cast<float>(0.1);
constexpr float kQuatEps = static_cast<float>(1e-12);
constexpr float kOpFloor = static_cast<float>(1e-12);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

// torch.clamp_min / torch.clamp / torch.minimum, NaN propagating as
// PyTorch's CUDA kernels are.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

// a0*x + a1*y + a2*z + a3, left to right, each op rounded.
__device__ __forceinline__ float affine(const float* a, float x, float y, float z) {
  return add(add(add(mul(a[0], x), mul(a[1], y)), mul(a[2], z)), a[3]);
}

// The tile index of a pixel coordinate: clamp(floor(v * inv), 0, tiles),
// cast to int as .to(torch.int32) casts.
__device__ __forceinline__ int tile_of(float v, float inv, int tiles) {
  return static_cast<int>(clamp(floorf(mul(v, inv)), 0.0f, static_cast<float>(tiles)));
}

struct Config {
  int n, width, height, tile_w, tile_h, tiles_x, tiles_y, clamp_mode, tight;
  float scale_modifier, z_near_cull, dilation;
};

// 16 bytes from device memory into shared memory, asynchronously (cp.async,
// cached in L2 only); wait_all waits for every copy the thread issued.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int kDeg>
__global__ void __launch_bounds__(kThreads)
    preprocess_kernel(const float* __restrict__ means, const float* __restrict__ log_scales,
                      const float* __restrict__ quats, const float* __restrict__ opacities,
                      const float* __restrict__ sh, const uint8_t* __restrict__ alive,
                      const float* __restrict__ view, const float* __restrict__ proj,
                      const float* __restrict__ cam_pos, const float* __restrict__ tan_fovx,
                      const float* __restrict__ tan_fovy, Config c, float* __restrict__ out) {
  constexpr int kCoeffs = (kDeg + 1) * (kDeg + 1);
  constexpr int kVec = (3 * kCoeffs + 3) / 4;  // float4s of the SH row the degree reads
  constexpr int kPad = kVec | 1;               // a row's stride in shared memory, in float4s

  __shared__ float cam[kCamFloats];
  __shared__ float4 stage[kThreads * kPad];
  if (threadIdx.x < 16) {
    cam[threadIdx.x] = view[threadIdx.x];
    cam[16 + threadIdx.x] = proj[threadIdx.x];
  } else if (threadIdx.x < 19) {
    cam[16 + threadIdx.x] = cam_pos[threadIdx.x - 16];
  } else if (threadIdx.x == 19) {
    cam[35] = *tan_fovx;
    cam[36] = *tan_fovy;
  }

  // --- every load first (a lane past n loads Gaussian n - 1's and stores
  //     nothing) ---
  const size_t n = static_cast<size_t>(c.n);
  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads;
  const size_t g = base + threadIdx.x;
  const size_t gl = g < n ? g : n - 1;
  const float4* sh4 = reinterpret_cast<const float4*>(sh);
  const int rows = static_cast<int>(n - base < kThreads ? n - base : kThreads);
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int j = i - r * kVec;
    cp_async16(&stage[r * kPad + j], sh4 + (base + r) * 12 + j);
  }
  const float mx = __ldg(means + 3 * gl), my = __ldg(means + 3 * gl + 1),
              mz = __ldg(means + 3 * gl + 2);
  const float ls0 = __ldg(log_scales + 3 * gl), ls1 = __ldg(log_scales + 3 * gl + 1),
              ls2 = __ldg(log_scales + 3 * gl + 2);
  const float4 q = __ldg(reinterpret_cast<const float4*>(quats) + gl);
  const float raw_op = __ldg(opacities + gl);
  const bool is_alive = __ldg(alive + gl) != 0;
  cp_async_wait_all();
  __syncthreads();
  if (g >= n) return;
  float shv[4 * kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float4 v = stage[threadIdx.x * kPad + j];
    shv[4 * j] = v.x;
    shv[4 * j + 1] = v.y;
    shv[4 * j + 2] = v.z;
    shv[4 * j + 3] = v.w;
  }

  const float* v = cam;       // view, row-major [4, 4]
  const float* p = cam + 16;  // proj
  const float tanx = cam[35], tany = cam[36];
  const float w = static_cast<float>(c.width), h = static_cast<float>(c.height);

  // --- view/clip transforms (preprocess.comp:129-137) ---
  const float tx = affine(v, mx, my, mz);
  const float ty = affine(v + 4, mx, my, mz);
  const float depth = affine(v + 8, mx, my, mz);
  const bool in_front = depth > c.z_near_cull;
  const float p_w = rcp(in_front ? affine(p + 12, mx, my, mz) : 1.0f);
  const float ndc_x = mul(affine(p, mx, my, mz), p_w);
  const float ndc_y = mul(affine(p + 4, mx, my, mz), p_w);
  const float tz = in_front ? depth : 1.0f;

  // --- EWA 2D covariance (preprocess.comp:34-66) ---
  const float limx = mul(kClampFov, tanx), limy = mul(kClampFov, tany);
  const float txc = mul(clamp(__fdiv_rn(tx, tz), -limx, limx), tz);
  const float tyc = mul(clamp(__fdiv_rn(ty, tz), -limy, limy), tz);
  const float focal_x = mul(rcp(mul(2.0f, tanx)), w);
  const float focal_y = mul(rcp(mul(2.0f, tany)), h);
  const float inv_z = rcp(tz);
  const float inv_z2 = mul(inv_z, inv_z);
  const float j00 = mul(focal_x, inv_z);
  const float j02 = mul(mul(-focal_x, txc), inv_z2);
  const float j11 = mul(focal_y, inv_z);
  const float j12 = mul(mul(-focal_y, tyc), inv_z2);
  const float m00 = add(mul(j00, v[0]), mul(j02, v[8]));
  const float m01 = add(mul(j00, v[1]), mul(j02, v[9]));
  const float m02 = add(mul(j00, v[2]), mul(j02, v[10]));
  const float m10 = add(mul(j11, v[4]), mul(j12, v[8]));
  const float m11 = add(mul(j11, v[5]), mul(j12, v[9]));
  const float m12 = add(mul(j11, v[6]), mul(j12, v[10]));

  // --- 3D covariance (precomp_cov3d.comp:31-47) ---
  const float s0 = mul(expf(ls0), c.scale_modifier);
  const float s1 = mul(expf(ls1), c.scale_modifier);
  const float s2 = mul(expf(ls2), c.scale_modifier);
  const float ss0 = mul(s0, s0), ss1 = mul(s1, s1), ss2 = mul(s2, s2);
  const float qinv = rsqrtf(add(add(add(mul(q.x, q.x), mul(q.z, q.z)),
                                    add(mul(q.y, q.y), mul(q.w, q.w))),
                                kQuatEps));
  const float qw = mul(q.x, qinv), qx = mul(q.y, qinv), qy = mul(q.z, qinv),
              qz = mul(q.w, qinv);
  const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  const float r01 = mul(2.0f, sub(mul(qx, qy), mul(qz, qw)));
  const float r02 = mul(2.0f, add(mul(qx, qz), mul(qy, qw)));
  const float r10 = mul(2.0f, add(mul(qx, qy), mul(qz, qw)));
  const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  const float r12 = mul(2.0f, sub(mul(qy, qz), mul(qx, qw)));
  const float r20 = mul(2.0f, sub(mul(qx, qz), mul(qy, qw)));
  const float r21 = mul(2.0f, add(mul(qy, qz), mul(qx, qw)));
  const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
  const auto cov = [&](float a0, float a1, float a2, float b0, float b1, float b2) {
    return add(add(mul(mul(a0, b0), ss0), mul(mul(a1, b1), ss1)), mul(mul(a2, b2), ss2));
  };
  const float xx = cov(r00, r01, r02, r00, r01, r02);
  const float xy = cov(r00, r01, r02, r10, r11, r12);
  const float xz = cov(r00, r01, r02, r20, r21, r22);
  const float yy = cov(r10, r11, r12, r10, r11, r12);
  const float yz = cov(r10, r11, r12, r20, r21, r22);
  const float zz = cov(r20, r21, r22, r20, r21, r22);

  // cov2d = M Sigma M^T + dilation * I
  const auto dot3 = [](float a0, float a1, float a2, float b0, float b1, float b2) {
    return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
  };
  const float sm0x = dot3(xx, xy, xz, m00, m01, m02);
  const float sm0y = dot3(xy, yy, yz, m00, m01, m02);
  const float sm0z = dot3(xz, yz, zz, m00, m01, m02);
  const float sm1x = dot3(xx, xy, xz, m10, m11, m12);
  const float sm1y = dot3(xy, yy, yz, m10, m11, m12);
  const float sm1z = dot3(xz, yz, zz, m10, m11, m12);
  const float c_a = add(dot3(m00, m01, m02, sm0x, sm0y, sm0z), c.dilation);
  const float c_b = dot3(m10, m11, m12, sm0x, sm0y, sm0z);
  const float c_c = add(dot3(m10, m11, m12, sm1x, sm1y, sm1z), c.dilation);
  const float det = sub(mul(c_a, c_c), mul(c_b, c_b));
  const float inv_det = rcp(det > 0.0f ? det : 1.0f);

  // --- radius from max eigenvalue (preprocess.comp:148-152) ---
  const float mid = mul(0.5f, add(c_a, c_c));
  const float lam = add(mid, sqrtf(clamp_min(sub(mul(mid, mid), det), kLamFloor)));
  const float opacity = __fdiv_rn(1.0f, add(1.0f, expf(-raw_op)));  // torch.sigmoid
  const float lam0 = clamp_min(lam, 0.0f);
  float radius = ceilf(mul(3.0f, sqrtf(lam0)));
  if (c.tight) {
    const float op255 = mul(255.0f, opacity);
    const float mult2 = mul(2.0f, logf(clamp_min(op255, kOpFloor)));
    const float r_tight = add(ceilf(sqrtf(mul(lam0, clamp_min(mult2, 0.0f)))), 2.0f);
    radius = op255 < 1.0f ? 0.0f : minimum(radius, r_tight);
  }

  // --- pixel center and tile AABB (preprocess.comp:155-165) ---
  const float uv_x = mul(sub(mul(add(ndc_x, 1.0f), w), 1.0f), 0.5f);
  const float uv_y = mul(sub(mul(add(ndc_y, 1.0f), h), 1.0f), 0.5f);
  const float inv_tw = rcp(static_cast<float>(c.tile_w));
  const float inv_th = rcp(static_cast<float>(c.tile_h));
  const float tw1 = static_cast<float>(c.tile_w), th1 = static_cast<float>(c.tile_h);
  const int x0 = tile_of(sub(uv_x, radius), inv_tw, c.tiles_x);
  const int y0 = tile_of(sub(uv_y, radius), inv_th, c.tiles_y);
  const int x1 = tile_of(sub(add(add(uv_x, radius), tw1), 1.0f), inv_tw, c.tiles_x);
  const int y1 = tile_of(sub(add(add(uv_y, radius), th1), 1.0f), inv_th, c.tiles_y);
  const int ntiles = max(x1 - x0, 0) * max(y1 - y0, 0);
  // radius == 0 marks an invisible Gaussian (reachable with tight_radius).
  const bool visible = in_front && det > 0.0f && is_alive && ntiles > 0 && radius > 0.0f;

  // --- SH colour (preprocess.comp:72-108) ---
  float dx = sub(mx, cam[32]), dy = sub(my, cam[33]), dz = sub(mz, cam[34]);
  const float dinv = rsqrtf(add(add(mul(dx, dx), mul(dz, dz)), mul(dy, dy)));
  dx = mul(dx, dinv);
  dy = mul(dy, dinv);
  dz = mul(dz, dinv);
  float basis[kCoeffs];
  basis[0] = kC0;
  if constexpr (kDeg >= 1) {
    basis[1] = mul(-kC1, dy);
    basis[2] = mul(kC1, dz);
    basis[3] = mul(-kC1, dx);
  }
  if constexpr (kDeg >= 2) {
    const float xx2 = mul(dx, dx), yy2 = mul(dy, dy), zz2 = mul(dz, dz);
    basis[4] = mul(mul(kC20, dx), dy);
    basis[5] = mul(mul(kC21, dy), dz);
    basis[6] = mul(kC22, sub(sub(mul(2.0f, zz2), xx2), yy2));
    basis[7] = mul(mul(kC23, dz), dx);
    basis[8] = mul(kC24, sub(xx2, yy2));
    if constexpr (kDeg >= 3) {
      basis[9] = mul(mul(kC30, sub(mul(3.0f, xx2), yy2)), dy);
      basis[10] = mul(mul(mul(kC31, dx), dy), dz);
      basis[11] = mul(mul(kC32, sub(sub(mul(4.0f, zz2), xx2), yy2)), dy);
      basis[12] = mul(mul(kC33, dz),
                      sub(sub(mul(2.0f, zz2), mul(3.0f, xx2)), mul(3.0f, yy2)));
      basis[13] = mul(mul(kC34, dx), sub(sub(mul(4.0f, zz2), xx2), yy2));
      basis[14] = mul(mul(kC35, sub(xx2, yy2)), dz);
      basis[15] = mul(mul(kC36, dx), sub(xx2, mul(3.0f, yy2)));
    }
  }
  float color[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    // torch.sum over the coefficients: coefficient k into accumulator k % 4,
    // then ((a0 + a1) + a2) + a3.
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kCoeffs; ++k) acc[k % 4] = add(acc[k % 4], mul(basis[k], shv[3 * k + ch]));
    color[ch] = add(add(add(add(acc[0], acc[1]), acc[2]), acc[3]), 0.5f);
  }
  if (c.clamp_mode == 0) {  // "red", the reference quirk: only c.x clamped
    color[0] = clamp_min(color[0], 0.0f);
  } else if (c.clamp_mode == 1) {  // "all"
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) color[ch] = clamp_min(color[ch], 0.0f);
  }

  // --- outputs: aabb [n, 4] int32, the table [9, n] (uv, conic,
  //     opacity, color as rows), depth [n], radius [n], ntiles [n] int32 ---
  reinterpret_cast<int4*>(out)[g] = make_int4(x0, y0, x1, y1);
  float* table = out + 4 * n + g;
  table[0] = uv_x;
  table[n] = uv_y;
  table[2 * n] = mul(c_c, inv_det);
  table[3 * n] = mul(-c_b, inv_det);
  table[4 * n] = mul(c_a, inv_det);
  table[5 * n] = opacity;
  table[6 * n] = color[0];
  table[7 * n] = color[1];
  table[8 * n] = color[2];
  out[13 * n + g] = depth;
  out[14 * n + g] = visible ? radius : 0.0f;
  reinterpret_cast<int*>(out)[15 * n + g] = visible ? ntiles : 0;
}

template <int kDeg>
void launch(const float* const* in, const uint8_t* alive, const Config& c, float* out,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(c.n) + kThreads - 1) /
                                                kThreads);
  preprocess_kernel<kDeg><<<blocks, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], alive, in[5], in[6], in[7], in[8], in[9], c, out);
}

}  // namespace

// One launch for n Gaussians into `out` (16 n words: see the kernel's
// outputs). clamp_mode: 0 red, 1 all, 2 none. Returns the launch's
// cudaError_t (0 at n == 0, where nothing is launched).
extern "C" int tpusplat_preprocess(const float* means, const float* log_scales,
                                   const float* quats, const float* opacities, const float* sh,
                                   const uint8_t* alive, const float* view, const float* proj,
                                   const float* cam_pos, const float* tan_fovx,
                                   const float* tan_fovy, int n, int width, int height,
                                   int tile_w, int tile_h, int tiles_x, int tiles_y,
                                   int sh_degree, int clamp_mode, int tight,
                                   float scale_modifier, float z_near_cull, float dilation,
                                   float* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Config c{n, width, height, tile_w, tile_h, tiles_x, tiles_y, clamp_mode, tight,
                 scale_modifier, z_near_cull, dilation};
  const float* in[] = {means, log_scales, quats, opacities, sh,
                       view, proj, cam_pos, tan_fovx, tan_fovy};
  switch (sh_degree) {
    case 0: launch<0>(in, alive, c, out, stream); break;
    case 1: launch<1>(in, alive, c, out, stream); break;
    case 2: launch<2>(in, alive, c, out, stream); break;
    case 3: launch<3>(in, alive, c, out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
