// Per-Gaussian preprocess for one camera, and its backward, for Hopper
// (sm_90a).
//
// Replace no TPU kernel: the JAX package computes preprocess outside
// Pallas (tpusplat/ops/preprocess.py, elementwise jnp that XLA fuses, and
// its gradient by autodiff). They were added because the port's plain
// version of it on the card, tpusplat_torch/ops/preprocess.py::
// preprocess_plain, is some 150 elementwise kernels and four torch.stack
// copies, about 30x its byte bound, and its backward through autograd as
// many again. The forward kernel serves every CUDA call; where autograd
// records the call for the parameters, ops/preprocess.py's autograd
// Function pairs it with the backward kernel (preprocess_backward_kernel,
// below, with its own note). The plain version stays the route of the CPU
// and of a call whose camera requires grad (no kernel writes a camera
// gradient), and the yardstick chip_smoke.py holds both kernels to.
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

// ---------------------------------------------------------------------------
// The backward (preprocess_backward_kernel): the gradients of means,
// log_scales, quats, opacities and sh from the gradient of the [9, n] table
// (ops/rasterize.py's gather_grad reduces it), which autograd of
// preprocess_plain would give.
//
// Bound: bytes. A Gaussian reads 272 B at SH degree 3 (means 12, log_scales
// 12, quats 16, opacity 4, SH 192, the table's gradient 36) and writes 236
// (the five gradients: 12, 12, 16, 4, 192): 508 B, at garden's 1.4M
// Gaussians 0.71 GB, 0.212 ms at 3.35 TB/s, at bicycle's 6M 3.05 GB,
// 0.910 ms. Its 778 float operations a Gaussian (splatbench's work model)
// would take 0.016 ms at garden at 67 TFLOP/s.
//
// Design:
//  * One thread a Gaussian and no atomics: each gradient is one thread's
//    sum in a fixed order, so the result is the same bit for bit from run
//    to run and between a graph replay and an eager call.
//  * Nothing is saved by the forward: the forward's intermediates are
//    recomputed in registers with the forward kernel's arithmetic, op for
//    op, so every mask (the Jacobian clamp, the depth and det guards, the
//    colour clamp) is the forward's. The camera is read from device memory
//    as the forward reads it, so that a graph replay sees each step's.
//  * Rounding: each gradient is formed and added as autograd of
//    preprocess_plain forms and adds it on the card: a product's gradient
//    as PyTorch's derivative formulas write it (grad * other; rsqrt's
//    -0.5 grad r^3; reciprocal's -grad r^2; a / b's -grad (a / b) / b), a
//    tensor's contributions added in the order autograd's engine adds them
//    (the consumer created last first), and the three sums over a last axis
//    (the RGB of each SH coefficient, the view direction, the quaternion)
//    in torch.sum's order on the card. preprocess_backward_plain is the
//    same arithmetic in PyTorch; on the CPU it equals autograd bit for bit
//    (tests/test_torch_preprocess_backward.py), and chip_smoke.py's
//    preprocess_bwd phase holds this kernel to both on the card.
//  * Loads as the forward's: the SH rows the degree reads through shared
//    memory in coalesced cp.async copies, the table's gradient row by row.
//    Stores: quats' gradient one float4 a thread and opacities' one word,
//    both coalesced; the SH rows' gradients (192 B a thread, zeros past the
//    degree's coefficients, as autograd gives them) and the [n, 3]
//    gradients of means and log_scales are staged in shared memory and
//    leave in coalesced 16-byte stores.

struct BackwardConfig {
  int n, width, height, clamped;  // colour channels clamp_min clamps, from red on
  float scale_modifier, z_near_cull, dilation;
};

// A gradient's sum over its contributions, added in the order the caller
// gives them (autograd's: the last created consumer first). The first
// contribution is taken as it is, as autograd takes it.
struct Acc {
  float v = 0.0f;
  bool any = false;
  __device__ __forceinline__ void operator+=(float x) {
    v = any ? add(v, x) : x;
    any = true;
  }
};

constexpr int kShRow = 12;          // float4s of a whole SH row (16 coefficients x RGB)
constexpr int kShPad = kShRow | 1;  // its stride in shared memory, odd: no bank conflicts

// The count floats of `src` (shared) to `dst` (device memory, 16-byte
// aligned) in coalesced 16-byte stores, the tail in 4-byte ones.
__device__ __forceinline__ void store_block(float* __restrict__ dst, const float* src,
                                            int count) {
  const int vec = count / 4;
  for (int i = threadIdx.x; i < vec; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * vec + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

template <int kDeg>
__global__ void __launch_bounds__(kThreads)
    preprocess_backward_kernel(const float* __restrict__ means,
                               const float* __restrict__ log_scales,
                               const float* __restrict__ quats,
                               const float* __restrict__ opacities,
                               const float* __restrict__ sh, const float* __restrict__ view,
                               const float* __restrict__ proj,
                               const float* __restrict__ cam_pos,
                               const float* __restrict__ tan_fovx,
                               const float* __restrict__ tan_fovy,
                               const float* __restrict__ d_table, BackwardConfig c,
                               float* __restrict__ d_means, float* __restrict__ d_log_scales,
                               float* __restrict__ d_quats, float* __restrict__ d_opacities,
                               float* __restrict__ d_sh) {
  constexpr int kCoeffs = (kDeg + 1) * (kDeg + 1);
  constexpr int kVec = (3 * kCoeffs + 3) / 4;  // float4s of the SH row the degree reads

  __shared__ float cam[kCamFloats];
  __shared__ float4 stage[kThreads * kShPad];  // SH rows in, their gradients out
  __shared__ float4 tri[2][kThreads * 3 / 4];  // the means' and log_scales' gradients out
  if (threadIdx.x < 16) {
    cam[threadIdx.x] = view[threadIdx.x];
    cam[16 + threadIdx.x] = proj[threadIdx.x];
  } else if (threadIdx.x < 19) {
    cam[16 + threadIdx.x] = cam_pos[threadIdx.x - 16];
  } else if (threadIdx.x == 19) {
    cam[35] = *tan_fovx;
    cam[36] = *tan_fovy;
  }

  // --- every load first (a lane past n works on Gaussian n - 1 and stores
  //     nothing) ---
  const size_t n = static_cast<size_t>(c.n);
  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads;
  const size_t g = base + threadIdx.x;
  const size_t gl = g < n ? g : n - 1;
  const int rows = static_cast<int>(n - base < kThreads ? n - base : kThreads);
  const float4* sh4 = reinterpret_cast<const float4*>(sh);
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int j = i - r * kVec;
    cp_async16(&stage[r * kShPad + j], sh4 + (base + r) * kShRow + j);
  }
  const float mx = __ldg(means + 3 * gl), my = __ldg(means + 3 * gl + 1),
              mz = __ldg(means + 3 * gl + 2);
  float e[3], s[3], ss[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) e[k] = __ldg(log_scales + 3 * gl + k);
  const float4 q = __ldg(reinterpret_cast<const float4*>(quats) + gl);
  const float raw_op = __ldg(opacities + gl);
  float gt[9];
#pragma unroll
  for (int r = 0; r < 9; ++r) gt[r] = __ldg(d_table + r * n + gl);
  cp_async_wait_all();
  __syncthreads();
  float shv[4 * kVec];
  float4* row = stage + threadIdx.x * kShPad;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float4 v = row[j];
    shv[4 * j] = v.x;
    shv[4 * j + 1] = v.y;
    shv[4 * j + 2] = v.z;
    shv[4 * j + 3] = v.w;
  }

  // --- the forward's intermediates, recomputed as the forward kernel
  //     computes them (so every mask below is the forward's) ---
  const float* v = cam;
  const float* p = cam + 16;
  const float tanx = cam[35], tany = cam[36];
  const float w = static_cast<float>(c.width), h = static_cast<float>(c.height);
  const float tx = affine(v, mx, my, mz);
  const float ty = affine(v + 4, mx, my, mz);
  const float depth = affine(v + 8, mx, my, mz);
  const bool in_front = depth > c.z_near_cull;
  const float p_w = rcp(in_front ? affine(p + 12, mx, my, mz) : 1.0f);
  const float pxn = affine(p, mx, my, mz), pyn = affine(p + 4, mx, my, mz);
  const float tz = in_front ? depth : 1.0f;
  const float limx = mul(kClampFov, tanx), limy = mul(kClampFov, tany);
  const float ux = __fdiv_rn(tx, tz), uy = __fdiv_rn(ty, tz);
  const float uxc = clamp(ux, -limx, limx), uyc = clamp(uy, -limy, limy);
  const float txc = mul(uxc, tz), tyc = mul(uyc, tz);
  const float focal_x = mul(rcp(mul(2.0f, tanx)), w);
  const float focal_y = mul(rcp(mul(2.0f, tany)), h);
  const float inv_z = rcp(tz);
  const float inv_z2 = mul(inv_z, inv_z);
  const float j00 = mul(focal_x, inv_z);
  const float nfx_txc = mul(-focal_x, txc);
  const float j02 = mul(nfx_txc, inv_z2);
  const float j11 = mul(focal_y, inv_z);
  const float nfy_tyc = mul(-focal_y, tyc);
  const float j12 = mul(nfy_tyc, inv_z2);
  const float m00 = add(mul(j00, v[0]), mul(j02, v[8]));
  const float m01 = add(mul(j00, v[1]), mul(j02, v[9]));
  const float m02 = add(mul(j00, v[2]), mul(j02, v[10]));
  const float m10 = add(mul(j11, v[4]), mul(j12, v[8]));
  const float m11 = add(mul(j11, v[5]), mul(j12, v[9]));
  const float m12 = add(mul(j11, v[6]), mul(j12, v[10]));

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = expf(e[k]);
    s[k] = mul(e[k], c.scale_modifier);
    ss[k] = mul(s[k], s[k]);
  }
  const float qinv = rsqrtf(add(add(add(mul(q.x, q.x), mul(q.z, q.z)),
                                    add(mul(q.y, q.y), mul(q.w, q.w))),
                                kQuatEps));
  const float qw = mul(q.x, qinv), qx = mul(q.y, qinv), qy = mul(q.z, qinv),
              qz = mul(q.w, qinv);
  const float r[3][3] = {
      {sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz)))), mul(2.0f, sub(mul(qx, qy), mul(qz, qw))),
       mul(2.0f, add(mul(qx, qz), mul(qy, qw)))},
      {mul(2.0f, add(mul(qx, qy), mul(qz, qw))), sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz)))),
       mul(2.0f, sub(mul(qy, qz), mul(qx, qw)))},
      {mul(2.0f, sub(mul(qx, qz), mul(qy, qw))), mul(2.0f, add(mul(qy, qz), mul(qx, qw))),
       sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))))}};
  const auto cov = [&](int i, int j) {
    return add(add(mul(mul(r[i][0], r[j][0]), ss[0]), mul(mul(r[i][1], r[j][1]), ss[1])),
               mul(mul(r[i][2], r[j][2]), ss[2]));
  };
  const float xx = cov(0, 0), xy = cov(0, 1), xz = cov(0, 2), yy = cov(1, 1), yz = cov(1, 2),
              zz = cov(2, 2);
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
  const float opacity = __fdiv_rn(1.0f, add(1.0f, expf(-raw_op)));  // torch.sigmoid

  const float dxr = sub(mx, cam[32]), dyr = sub(my, cam[33]), dzr = sub(mz, cam[34]);
  const float dinv = rsqrtf(add(add(mul(dxr, dxr), mul(dzr, dzr)), mul(dyr, dyr)));
  const float x = mul(dxr, dinv), y = mul(dyr, dinv), z = mul(dzr, dinv);
  float basis[kCoeffs];
  basis[0] = kC0;
  if constexpr (kDeg >= 1) {
    basis[1] = mul(-kC1, y);
    basis[2] = mul(kC1, z);
    basis[3] = mul(-kC1, x);
  }
  if constexpr (kDeg >= 2) {
    const float xx2 = mul(x, x), yy2 = mul(y, y), zz2 = mul(z, z);
    basis[4] = mul(mul(kC20, x), y);
    basis[5] = mul(mul(kC21, y), z);
    basis[6] = mul(kC22, sub(sub(mul(2.0f, zz2), xx2), yy2));
    basis[7] = mul(mul(kC23, z), x);
    basis[8] = mul(kC24, sub(xx2, yy2));
    if constexpr (kDeg >= 3) {
      basis[9] = mul(mul(kC30, sub(mul(3.0f, xx2), yy2)), y);
      basis[10] = mul(mul(mul(kC31, x), y), z);
      basis[11] = mul(mul(kC32, sub(sub(mul(4.0f, zz2), xx2), yy2)), y);
      basis[12] = mul(mul(kC33, z), sub(sub(mul(2.0f, zz2), mul(3.0f, xx2)), mul(3.0f, yy2)));
      basis[13] = mul(mul(kC34, x), sub(sub(mul(4.0f, zz2), xx2), yy2));
      basis[14] = mul(mul(kC35, sub(xx2, yy2)), z);
      basis[15] = mul(mul(kC36, x), sub(xx2, mul(3.0f, yy2)));
    }
  }

  // --- the gradients, each formed and added as autograd of
  //     preprocess_plain forms and adds it (preprocess_backward_plain) ---
  const float d_op = mul(mul(gt[5], sub(1.0f, opacity)), opacity);  // torch.sigmoid's

  // SH colour: the clamp passes where c >= 0; then the coefficients and the basis
  float dc[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    dc[ch] = gt[6 + ch];
    if (ch < c.clamped) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the forward's colour, its sum order
#pragma unroll
      for (int k = 0; k < kCoeffs; ++k)
        acc[k % 4] = add(acc[k % 4], mul(basis[k], shv[3 * k + ch]));
      const float col = add(add(add(add(acc[0], acc[1]), acc[2]), acc[3]), 0.5f);
      if (!(col >= 0.0f)) dc[ch] = 0.0f;
    }
  }
  float db[kCoeffs];  // sum over RGB in torch.sum's order on the card: (c0 + c2) + c1
#pragma unroll
  for (int k = 0; k < kCoeffs; ++k)
    db[k] = add(add(mul(dc[0], shv[3 * k]), mul(dc[2], shv[3 * k + 2])),
                mul(dc[1], shv[3 * k + 1]));
  Acc gx, gy, gz;  // the unit direction's gradient, the last created consumer first
  if constexpr (kDeg >= 3) {
    const float xx3 = mul(x, x), yy3 = mul(y, y), zz3 = mul(z, z);
    const float a10 = mul(kC31, x);
    const float d_b10 = mul(db[10], z);
    const float s13 = sub(sub(mul(4.0f, zz3), xx3), yy3);
    const float d_s9 = mul(mul(db[9], y), kC30);
    const float d_s11 = mul(mul(db[11], y), kC32);
    const float d_s12 = mul(db[12], mul(kC33, z));
    const float d_s13 = mul(db[13], mul(kC34, x));
    const float d_r14 = mul(mul(db[14], z), kC35);
    const float d_r15 = mul(db[15], mul(kC36, x));
    Acc d_xx, d_yy, d_zz;
    d_xx += d_r15;
    d_xx += d_r14;
    d_xx += -d_s13;
    d_xx += mul(-d_s12, 3.0f);
    d_xx += -d_s11;
    d_xx += mul(d_s9, 3.0f);
    d_yy += mul(-d_r15, 3.0f);
    d_yy += -d_r14;
    d_yy += -d_s13;
    d_yy += mul(-d_s12, 3.0f);
    d_yy += -d_s11;
    d_yy += -d_s9;
    d_zz += mul(d_s13, 4.0f);
    d_zz += mul(d_s12, 2.0f);
    d_zz += mul(d_s11, 4.0f);
    gx += mul(mul(db[15], sub(xx3, mul(3.0f, yy3))), kC36);
    gx += mul(mul(db[13], s13), kC34);
    gx += mul(mul(d_b10, y), kC31);
    gx += mul(d_xx.v, x);
    gx += mul(d_xx.v, x);
    gy += mul(db[11], mul(kC32, s13));
    gy += mul(d_b10, a10);
    gy += mul(db[9], mul(kC30, sub(mul(3.0f, xx3), yy3)));
    gy += mul(d_yy.v, y);
    gy += mul(d_yy.v, y);
    gz += mul(db[14], mul(kC35, sub(xx3, yy3)));
    gz += mul(mul(db[12], sub(sub(mul(2.0f, zz3), mul(3.0f, xx3)), mul(3.0f, yy3))), kC33);
    gz += mul(db[10], mul(a10, y));
    gz += mul(d_zz.v, z);
    gz += mul(d_zz.v, z);
  }
  if constexpr (kDeg >= 2) {
    const float d_q6 = mul(db[6], kC22), d_r8 = mul(db[8], kC24);
    const float d_xx = add(d_r8, -d_q6), d_yy = add(-d_r8, -d_q6), d_zz = mul(d_q6, 2.0f);
    gx += mul(db[7], mul(kC23, z));
    gx += mul(mul(db[4], y), kC20);
    gx += mul(d_xx, x);
    gx += mul(d_xx, x);
    gy += mul(mul(db[5], z), kC21);
    gy += mul(db[4], mul(kC20, x));
    gy += mul(d_yy, y);
    gy += mul(d_yy, y);
    gz += mul(mul(db[7], x), kC23);
    gz += mul(db[5], mul(kC21, y));
    gz += mul(d_zz, z);
    gz += mul(d_zz, z);
  }
  if constexpr (kDeg >= 1) {
    gx += mul(db[3], -kC1);
    gy += mul(db[1], -kC1);
    gz += mul(db[2], kC1);
  }
  // the direction d * rsqrt(|d|^2): rsqrt's backward, its sum in torch.sum's order
  const float d_sq = mul(mul(-0.5f, add(add(mul(gx.v, dxr), mul(gz.v, dzr)), mul(gy.v, dyr))),
                         mul(mul(dinv, dinv), dinv));
  const float d_dx = add(add(mul(gx.v, dinv), mul(d_sq, dxr)), mul(d_sq, dxr));
  const float d_dy = add(add(mul(gy.v, dinv), mul(d_sq, dyr)), mul(d_sq, dyr));
  const float d_dz = add(add(mul(gz.v, dinv), mul(d_sq, dzr)), mul(d_sq, dzr));

  // conic = (c_c, -c_b, c_a) / det, det guarded where det <= 0
  const float d_inv = add(add(mul(gt[4], c_a), mul(gt[3], -c_b)), mul(gt[2], c_c));
  const float d_det = det > 0.0f ? mul(-d_inv, mul(inv_det, inv_det)) : 0.0f;
  const float d_ca = add(mul(gt[4], inv_det), mul(d_det, c_c));
  const float d_cb = add(add(-mul(gt[3], inv_det), mul(-d_det, c_b)), mul(-d_det, c_b));
  const float d_cc = add(mul(gt[2], inv_det), mul(d_det, c_a));

  // cov2d = M Sigma M^T, through sm0 = Sigma M0 and sm1 = Sigma M1
  const float d_sm0x = add(mul(d_cb, m10), mul(d_ca, m00));
  const float d_sm0y = add(mul(d_cb, m11), mul(d_ca, m01));
  const float d_sm0z = add(mul(d_cb, m12), mul(d_ca, m02));
  const float d_sm1x = mul(d_cc, m10), d_sm1y = mul(d_cc, m11), d_sm1z = mul(d_cc, m12);
  const auto sum4 = [](float a, float b, float c3, float d) { return add(add(add(a, b), c3), d); };
  const float d_m00 = sum4(mul(d_ca, sm0x), mul(d_sm0z, xz), mul(d_sm0y, xy), mul(d_sm0x, xx));
  const float d_m01 = sum4(mul(d_ca, sm0y), mul(d_sm0z, yz), mul(d_sm0y, yy), mul(d_sm0x, xy));
  const float d_m02 = sum4(mul(d_ca, sm0z), mul(d_sm0z, zz), mul(d_sm0y, yz), mul(d_sm0x, xz));
  const float d_m10 = add(sum4(mul(d_cc, sm1x), mul(d_cb, sm0x), mul(d_sm1z, xz),
                               mul(d_sm1y, xy)), mul(d_sm1x, xx));
  const float d_m11 = add(sum4(mul(d_cc, sm1y), mul(d_cb, sm0y), mul(d_sm1z, yz),
                               mul(d_sm1y, yy)), mul(d_sm1x, xy));
  const float d_m12 = add(sum4(mul(d_cc, sm1z), mul(d_cb, sm0z), mul(d_sm1z, zz),
                               mul(d_sm1y, yz)), mul(d_sm1x, xz));
  float d_cov[3][3];  // the six entries' gradients, [i][j] for i <= j
  d_cov[0][0] = add(mul(d_sm1x, m10), mul(d_sm0x, m00));
  d_cov[0][1] = sum4(mul(d_sm1y, m10), mul(d_sm1x, m11), mul(d_sm0y, m00), mul(d_sm0x, m01));
  d_cov[0][2] = sum4(mul(d_sm1z, m10), mul(d_sm1x, m12), mul(d_sm0z, m00), mul(d_sm0x, m02));
  d_cov[1][1] = add(mul(d_sm1y, m11), mul(d_sm0y, m01));
  d_cov[1][2] = sum4(mul(d_sm1z, m11), mul(d_sm1y, m12), mul(d_sm0z, m01), mul(d_sm0y, m02));
  d_cov[2][2] = add(mul(d_sm1z, m12), mul(d_sm0z, m02));

  // M = J V3; J from 1 / tz and the clamped tx, ty
  const float d_j00 = add(add(mul(d_m02, v[2]), mul(d_m01, v[1])), mul(d_m00, v[0]));
  const float d_j02 = add(add(mul(d_m02, v[10]), mul(d_m01, v[9])), mul(d_m00, v[8]));
  const float d_j11 = add(add(mul(d_m12, v[6]), mul(d_m11, v[5])), mul(d_m10, v[4]));
  const float d_j12 = add(add(mul(d_m12, v[10]), mul(d_m11, v[9])), mul(d_m10, v[8]));
  const float d_inv_z2 = add(mul(d_j12, nfy_tyc), mul(d_j02, nfx_txc));
  const float d_inv_z = add(add(add(mul(d_j11, focal_y), mul(d_j00, focal_x)),
                                mul(d_inv_z2, inv_z)), mul(d_inv_z2, inv_z));
  const float d_txc = mul(mul(d_j02, inv_z2), -focal_x);
  const float d_tyc = mul(mul(d_j12, inv_z2), -focal_y);
  // the clamp passes where -lim <= t <= lim, inclusive (clamp's backward)
  const float d_ux = ux >= -limx && ux <= limx ? mul(d_txc, tz) : 0.0f;
  const float d_uy = uy >= -limy && uy <= limy ? mul(d_tyc, tz) : 0.0f;
  const float d_tz = add(sum4(mul(-d_inv_z, mul(inv_z, inv_z)), mul(d_tyc, uyc), mul(d_txc, uxc),
                              mul(-d_uy, __fdiv_rn(uy, tz))),
                         mul(-d_ux, __fdiv_rn(ux, tz)));
  const float d_tx = __fdiv_rn(d_ux, tz), d_ty = __fdiv_rn(d_uy, tz);
  const float d_depth = in_front ? d_tz : 0.0f;

  // uv = ((ndc + 1) S - 1) / 2, ndc = (P m) / w, w guarded behind z_near_cull
  const float d_ndcx = mul(mul(gt[0], 0.5f), w), d_ndcy = mul(mul(gt[1], 0.5f), h);
  const float d_pw = add(mul(d_ndcy, pyn), mul(d_ndcx, pxn));
  const float d_phw = in_front ? mul(-d_pw, mul(p_w, p_w)) : 0.0f;
  const float d_pxn = mul(d_ndcx, p_w), d_pyn = mul(d_ndcy, p_w);
  const float d_dir[3] = {d_dx, d_dy, d_dz};
  float* tri_means = reinterpret_cast<float*>(tri[0]) + 3 * threadIdx.x;
  float* tri_scales = reinterpret_cast<float*>(tri[1]) + 3 * threadIdx.x;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    tri_means[k] = add(d_dir[k], add(sum4(add(mul(d_pyn, p[4 + k]), mul(d_pxn, p[k])),
                                          mul(d_phw, p[12 + k]), mul(d_depth, v[8 + k]),
                                          mul(d_ty, v[4 + k])),
                                     mul(d_tx, v[k])));

  // Sigma = sum_k ss_k R[:, k] R[:, k]^T: the scales, then R
  float d_r[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float r0 = r[0][k], r1 = r[1][k], r2 = r[2][k];
    const float d_ss = add(add(add(add(add(mul(d_cov[2][2], mul(r2, r2)),
                                           mul(d_cov[1][2], mul(r1, r2))),
                                       mul(d_cov[1][1], mul(r1, r1))),
                                   mul(d_cov[0][2], mul(r0, r2))),
                               mul(d_cov[0][1], mul(r0, r1))),
                           mul(d_cov[0][0], mul(r0, r0)));
    const float a_xx = mul(d_cov[0][0], ss[k]), a_xy = mul(d_cov[0][1], ss[k]),
                a_xz = mul(d_cov[0][2], ss[k]), a_yy = mul(d_cov[1][1], ss[k]),
                a_yz = mul(d_cov[1][2], ss[k]), a_zz = mul(d_cov[2][2], ss[k]);
    d_r[0][k] = sum4(mul(a_xz, r2), mul(a_xy, r1), mul(a_xx, r0), mul(a_xx, r0));
    d_r[1][k] = sum4(mul(a_yz, r2), mul(a_yy, r1), mul(a_yy, r1), mul(a_xy, r0));
    d_r[2][k] = sum4(mul(a_zz, r2), mul(a_zz, r2), mul(a_yz, r1), mul(a_xz, r0));
    tri_scales[k] = mul(mul(mul(d_ss, mul(2.0f, s[k])), c.scale_modifier), e[k]);
  }

  // R of the unit quaternion (w, x, y, z), then q * rsqrt(|q|^2 + eps)
  const float k00 = mul(-d_r[0][0], 2.0f), k11 = mul(-d_r[1][1], 2.0f),
              k22 = mul(-d_r[2][2], 2.0f);
  const float k01 = mul(d_r[0][1], 2.0f), k02 = mul(d_r[0][2], 2.0f), k10 = mul(d_r[1][0], 2.0f),
              k12 = mul(d_r[1][2], 2.0f), k20 = mul(d_r[2][0], 2.0f), k21 = mul(d_r[2][1], 2.0f);
  Acc dqw, dqx, dqy, dqz;
  dqw += mul(k21, qx);
  dqw += mul(-k20, qy);
  dqw += mul(-k12, qx);
  dqw += mul(k10, qz);
  dqw += mul(k02, qy);
  dqw += mul(-k01, qz);
  dqx += mul(k22, qx);
  dqx += mul(k22, qx);
  dqx += mul(k21, qw);
  dqx += mul(k20, qz);
  dqx += mul(-k12, qw);
  dqx += mul(k11, qx);
  dqx += mul(k11, qx);
  dqx += mul(k10, qy);
  dqx += mul(k02, qz);
  dqx += mul(k01, qy);
  dqy += mul(k22, qy);
  dqy += mul(k22, qy);
  dqy += mul(k21, qz);
  dqy += mul(-k20, qw);
  dqy += mul(k12, qz);
  dqy += mul(k10, qx);
  dqy += mul(k02, qw);
  dqy += mul(k01, qx);
  dqy += mul(k00, qy);
  dqy += mul(k00, qy);
  dqz += mul(k21, qy);
  dqz += mul(k20, qx);
  dqz += mul(k12, qy);
  dqz += mul(k11, qz);
  dqz += mul(k11, qz);
  dqz += mul(k10, qw);
  dqz += mul(k02, qx);
  dqz += mul(-k01, qw);
  dqz += mul(k00, qz);
  dqz += mul(k00, qz);
  // the sum over the four components in torch.sum's order on the card
  const float d_qsq = mul(mul(-0.5f, add(add(mul(dqw.v, q.x), mul(dqy.v, q.z)),
                                         add(mul(dqx.v, q.y), mul(dqz.v, q.w)))),
                          mul(mul(qinv, qinv), qinv));
  const auto d_quat = [&](float d_qn, float qc) {
    return add(add(mul(d_qn, qinv), mul(d_qsq, qc)), mul(d_qsq, qc));
  };

  // --- the stores: quats and opacities one word or float4 a thread, the
  //     SH rows and the [n, 3] arrays staged in shared memory ---
  if (g < n) {
    reinterpret_cast<float4*>(d_quats)[g] =
        make_float4(d_quat(dqw.v, q.x), d_quat(dqx.v, q.y), d_quat(dqy.v, q.z),
                    d_quat(dqz.v, q.w));
    d_opacities[g] = d_op;
  }
#pragma unroll
  for (int j = 0; j < kShRow; ++j) {
    float d4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = 4 * j + i;  // coefficient f / 3, channel f % 3; zero past the degree's
      d4[i] = f / 3 < kCoeffs ? mul(dc[f % 3], basis[f / 3]) : 0.0f;
    }
    row[j] = make_float4(d4[0], d4[1], d4[2], d4[3]);
  }
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(d_sh) + base * kShRow;
  for (int i = threadIdx.x; i < rows * kShRow; i += kThreads) {
    const int rr = i / kShRow;
    out4[i] = stage[rr * kShPad + (i - rr * kShRow)];
  }
  store_block(d_means + 3 * base, reinterpret_cast<const float*>(tri[0]), 3 * rows);
  store_block(d_log_scales + 3 * base, reinterpret_cast<const float*>(tri[1]), 3 * rows);
}

template <int kDeg>
void launch_backward(const float* const* in, const float* d_table, const BackwardConfig& c,
                     float* const* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(c.n) + kThreads - 1) /
                                                kThreads);
  preprocess_backward_kernel<kDeg><<<blocks, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], d_table, c, out[0],
      out[1], out[2], out[3], out[4]);
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

// One launch of the backward for n Gaussians: from d_table ([9, n], the
// table's rows as the forward writes them) into d_means [n, 3],
// d_log_scales [n, 3], d_quats [n, 4], d_opacities [n] and d_sh [n, 16, 3]
// (zeros past the degree's coefficients). clamped: how many colour
// channels, from red on, the forward clamps (1 red, 3 all, 0 none).
// Returns the launch's cudaError_t (0 at n == 0, where nothing is launched).
extern "C" int tpusplat_preprocess_backward(
    const float* means, const float* log_scales, const float* quats, const float* opacities,
    const float* sh, const float* view, const float* proj, const float* cam_pos,
    const float* tan_fovx, const float* tan_fovy, const float* d_table, int n, int width,
    int height, int sh_degree, int clamped, float scale_modifier, float z_near_cull,
    float dilation, float* d_means, float* d_log_scales, float* d_quats, float* d_opacities,
    float* d_sh, cudaStream_t stream) {
  if (n <= 0) return 0;
  const BackwardConfig c{n, width, height, clamped, scale_modifier, z_near_cull, dilation};
  const float* in[] = {means, log_scales, quats, opacities, sh,
                       view, proj, cam_pos, tan_fovx, tan_fovy};
  float* out[] = {d_means, d_log_scales, d_quats, d_opacities, d_sh};
  switch (sh_degree) {
    case 0: launch_backward<0>(in, d_table, c, out, stream); break;
    case 1: launch_backward<1>(in, d_table, c, out, stream); break;
    case 2: launch_backward<2>(in, d_table, c, out, stream); break;
    case 3: launch_backward<3>(in, d_table, c, out, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
