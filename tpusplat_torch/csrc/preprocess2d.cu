// Per-surfel preprocess of 2D Gaussian Splatting for one camera, and its
// backward, for Hopper (sm_90a).
//
// Replace no TPU kernel: the JAX package renders 3D Gaussians only. Added so
// that a surfel scene (types.SurfelParams) takes the port's normal path on
// the card. Plain version: tpusplat_torch/ops/surfel.py::preprocess2d_plain
// (the backward: autograd of it).
//
// What the forward computes, one thread a surfel: R from the normalised
// quaternion; the scales exp(log_scales) * scale_modifier; the splat-to-pixel
// matrix T = K [R_cw | t_cw] [[s_u t_u, s_v t_v, p], [0, 0, 1]] (rows T_u,
// T_v, T_w; K of the port's pixel-centre convention: f = size / (2 tan_fov),
// c = (size - 1) / 2); the centre c of the 3-sigma disk's dual conic
// T diag(9, 9, -1) T^T, which the blend's low-pass filter is centred on; the
// normal R_cw t_w, flipped to face the camera; the opacity; the SH colour
// (degree 0-3, + 0.5, the red, all or none clamp); the tile box of the
// pixels at which the surfel can reach alpha_min (surfel.cuh's pixel_box,
// padded by half a pixel), its tile count and radius; the cull: alive,
// centre depth > z_near, the disk inside the camera's side (C*_33 < 0 at
// 3 sigma and at the box's cutoff), opacity >= alpha_min.
// Outputs go to one buffer of 25 words a surfel: aabb [n, 4] int32, the
// blend's [18, n] table (T_u, T_v, T_w, c, opacity, colour, normal), depth,
// radius, ntiles (int32).
//
// The backward recomputes those terms and takes the table's gradient back
// to means, log_scales, quats, opacities and sh, the masks frozen as
// autograd of the plain version freezes them (the colour clamp, the
// normal's flip, the dual conic's guard).
//
// Bound: bytes. The forward reads 233 B a surfel at SH degree 3 (means 12,
// log_scales 8, quats 16, opacity 4, SH 192, alive 1) and writes 100; the
// backward reads those and the table's gradient, 72 B, and writes 232.

#include <cuda_runtime.h>

#include "surfel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f, 0.31539156525252005f,
                          -1.0925484305920792f, 0.5462742152960396f};
__constant__ float kC3[7] = {-0.5900435899266435f, 2.890611442640554f, -0.4570457994644658f,
                          0.3731763325901154f,  -0.4570457994644658f, 1.445305721320277f,
                          -0.5900435899266435f};

struct Cam {
  float view[16];
  float pos[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ void load_cam(Cam& c, const float* view, const float* cam_pos,
                                         const float* tan_fovx, const float* tan_fovy,
                                         int width, int height) {
  for (int i = 0; i < 16; ++i) c.view[i] = view[i];
  for (int i = 0; i < 3; ++i) c.pos[i] = cam_pos[i];
  c.fx = static_cast<float>(width) / (2.0f * tan_fovx[0]);
  c.fy = static_cast<float>(height) / (2.0f * tan_fovy[0]);
  c.cx = (width - 1) * 0.5f;
  c.cy = (height - 1) * 0.5f;
}

// The real SH basis at the unit direction (x, y, z), its first (degree + 1)^2.
__device__ __forceinline__ void sh_basis(float x, float y, float z, float (&b)[16]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  b[0] = kC0;
  b[1] = -kC1 * y;
  b[2] = kC1 * z;
  b[3] = -kC1 * x;
  b[4] = kC2[0] * x * y;
  b[5] = kC2[1] * y * z;
  b[6] = kC2[2] * (2.0f * zz - xx - yy);
  b[7] = kC2[3] * z * x;
  b[8] = kC2[4] * (xx - yy);
  b[9] = kC3[0] * (3.0f * xx - yy) * y;
  b[10] = kC3[1] * x * y * z;
  b[11] = kC3[2] * (4.0f * zz - xx - yy) * y;
  b[12] = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = kC3[4] * x * (4.0f * zz - xx - yy);
  b[14] = kC3[5] * (xx - yy) * z;
  b[15] = kC3[6] * x * (xx - 3.0f * yy);
}

// The forward terms of one surfel that its backward reuses.
struct Terms {
  float q[4], qinv, qn[4];
  float r[3][3];  // R(qn), r[i][j] row i, column j
  float s[2];
  float pc[3];            // the centre in the camera frame
  float ax[3][3];         // ax[j] = R_cw R[:, j], the axes in the camera frame
  float tu[3], tv[3], tw[3];
  float sign;             // the normal's flip
  float d33, safe;        // 9 (Tw0^2 + Tw1^2) - Tw2^2 and its guard
  float nx, ny;           // the dual conic's numerators of c
  float op;
  float dn[3], dinv;      // the unit view direction and 1 / |p - cam_pos|
  float basis[16];
  float raw[3];           // the colour before its clamp
};

__device__ __forceinline__ void forward_terms(Terms& t, const Cam& c, const float* means,
                                              const float* log_scales, const float* quats,
                                              const float* opacities, const float* sh, int i,
                                              int degree, float scale_modifier) {
  const float p[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};
  for (int k = 0; k < 4; ++k) t.q[k] = quats[4 * i + k];
  t.qinv = rsqrtf(t.q[0] * t.q[0] + t.q[1] * t.q[1] + t.q[2] * t.q[2] + t.q[3] * t.q[3] + 1e-12f);
  for (int k = 0; k < 4; ++k) t.qn[k] = t.q[k] * t.qinv;
  const float w = t.qn[0], x = t.qn[1], y = t.qn[2], z = t.qn[3];
  t.r[0][0] = 1.0f - 2.0f * (y * y + z * z);
  t.r[0][1] = 2.0f * (x * y - z * w);
  t.r[0][2] = 2.0f * (x * z + y * w);
  t.r[1][0] = 2.0f * (x * y + z * w);
  t.r[1][1] = 1.0f - 2.0f * (x * x + z * z);
  t.r[1][2] = 2.0f * (y * z - x * w);
  t.r[2][0] = 2.0f * (x * z - y * w);
  t.r[2][1] = 2.0f * (y * z + x * w);
  t.r[2][2] = 1.0f - 2.0f * (x * x + y * y);
  t.s[0] = expf(log_scales[2 * i]) * scale_modifier;
  t.s[1] = expf(log_scales[2 * i + 1]) * scale_modifier;
  const float* v = c.view;
  for (int a = 0; a < 3; ++a) {
    t.pc[a] = v[4 * a] * p[0] + v[4 * a + 1] * p[1] + v[4 * a + 2] * p[2] + v[4 * a + 3];
    for (int j = 0; j < 3; ++j) {
      t.ax[j][a] = v[4 * a] * t.r[0][j] + v[4 * a + 1] * t.r[1][j] + v[4 * a + 2] * t.r[2][j];
    }
  }
  const float col[3][3] = {{t.s[0] * t.ax[0][0], t.s[0] * t.ax[0][1], t.s[0] * t.ax[0][2]},
                           {t.s[1] * t.ax[1][0], t.s[1] * t.ax[1][1], t.s[1] * t.ax[1][2]},
                           {t.pc[0], t.pc[1], t.pc[2]}};
  for (int j = 0; j < 3; ++j) {
    t.tu[j] = c.fx * col[j][0] + c.cx * col[j][2];
    t.tv[j] = c.fy * col[j][1] + c.cy * col[j][2];
    t.tw[j] = col[j][2];
  }
  const float facing = t.ax[2][0] * t.pc[0] + t.ax[2][1] * t.pc[1] + t.ax[2][2] * t.pc[2];
  t.sign = facing > 0.0f ? -1.0f : 1.0f;
  t.d33 = 9.0f * (t.tw[0] * t.tw[0] + t.tw[1] * t.tw[1]) - t.tw[2] * t.tw[2];
  t.safe = t.d33 < 0.0f ? t.d33 : -1.0f;
  t.nx = 9.0f * (t.tu[0] * t.tw[0] + t.tu[1] * t.tw[1]) - t.tu[2] * t.tw[2];
  t.ny = 9.0f * (t.tv[0] * t.tw[0] + t.tv[1] * t.tw[1]) - t.tv[2] * t.tw[2];
  t.op = 1.0f / (1.0f + expf(-opacities[i]));
  float d[3] = {p[0] - c.pos[0], p[1] - c.pos[1], p[2] - c.pos[2]};
  t.dinv = rsqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  for (int a = 0; a < 3; ++a) t.dn[a] = d[a] * t.dinv;
  sh_basis(t.dn[0], t.dn[1], t.dn[2], t.basis);
  const int kk = (degree + 1) * (degree + 1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < kk) acc += t.basis[k] * sh[48 * static_cast<long long>(i) + 3 * k + ch];
    }
    t.raw[ch] = acc + 0.5f;
  }
}

__global__ void __launch_bounds__(kThreads)
    preprocess2d_kernel(const float* __restrict__ means, const float* __restrict__ log_scales,
                        const float* __restrict__ quats, const float* __restrict__ opacities,
                        const float* __restrict__ sh, const bool* __restrict__ alive,
                        const float* __restrict__ view, const float* __restrict__ cam_pos,
                        const float* __restrict__ tan_fovx, const float* __restrict__ tan_fovy,
                        int n, int width, int height, int tile_w, int tile_h, int tiles_x,
                        int tiles_y, int degree, int clamp_mode, float scale_modifier,
                        float z_near, float alpha_min, float* __restrict__ out) {
  __shared__ Cam cam;
  if (threadIdx.x == 0) load_cam(cam, view, cam_pos, tan_fovx, tan_fovy, width, height);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Terms t;
  forward_terms(t, cam, means, log_scales, quats, opacities, sh, i, degree, scale_modifier);
  float v[kSurfelRows];
  for (int j = 0; j < 3; ++j) {
    v[j] = t.tu[j];
    v[3 + j] = t.tv[j];
    v[6 + j] = t.tw[j];
    v[15 + j] = t.sign * t.ax[2][j];
  }
  v[9] = t.nx / t.safe;
  v[10] = t.ny / t.safe;
  v[11] = t.op;
  const int clamped = clamp_mode == 0 ? 1 : clamp_mode == 1 ? 3 : 0;
  for (int ch = 0; ch < 3; ++ch) v[12 + ch] = ch < clamped ? fmaxf(t.raw[ch], 0.0f) : t.raw[ch];

  float box[12];
  for (int k = 0; k < 12; ++k) box[k] = v[k];
  double x0d, x1d, y0d, y1d;
  const bool boxed = surfel::pixel_box(box, alpha_min, x0d, x1d, y0d, y1d);
  int bx0 = 0, by0 = 0, bx1 = 0, by1 = 0;
  float radius = 0.0f;
  int ntiles = 0;
  if (boxed) {
    const double lx = x0d - 0.5, hx = x1d + 0.5, ly = y0d - 0.5, hy = y1d + 0.5;
    bx0 = static_cast<int>(fmin(fmax(floor(lx / tile_w), 0.0), static_cast<double>(tiles_x)));
    by0 = static_cast<int>(fmin(fmax(floor(ly / tile_h), 0.0), static_cast<double>(tiles_y)));
    bx1 = static_cast<int>(fmin(fmax(floor(hx / tile_w) + 1.0, 0.0), static_cast<double>(tiles_x)));
    by1 = static_cast<int>(fmin(fmax(floor(hy / tile_h) + 1.0, 0.0), static_cast<double>(tiles_y)));
    ntiles = max(bx1 - bx0, 0) * max(by1 - by0, 0);
    radius = static_cast<float>(0.5 * fmax(hx - lx, hy - ly));
  }
  const bool visible = alive[i] && t.pc[2] > z_near && t.d33 < 0.0f && boxed &&
                       t.op >= alpha_min && ntiles > 0;
  if (!visible) {
    ntiles = 0;
    radius = 0.0f;
  }
  const long long nn = n;
  int* ints = reinterpret_cast<int*>(out);
  ints[4 * i + 0] = bx0;
  ints[4 * i + 1] = by0;
  ints[4 * i + 2] = bx1;
  ints[4 * i + 3] = by1;
  for (int k = 0; k < kSurfelRows; ++k) out[(4 + k) * nn + i] = v[k];
  out[(4 + kSurfelRows) * nn + i] = t.pc[2];
  out[(5 + kSurfelRows) * nn + i] = radius;
  ints[(6 + kSurfelRows) * nn + i] = ntiles;
}

// d basis[k] / d (x, y, z) for the SH basis above, accumulated with the
// basis gradients db into g.
__device__ __forceinline__ void sh_basis_backward(float x, float y, float z,
                                                  const float (&db)[16], int kk, float (&g)[3]) {
  const float xx = x * x, yy = y * y, zz = z * z;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (kk > 1) {
    gy += -kC1 * db[1];
    gz += kC1 * db[2];
    gx += -kC1 * db[3];
  }
  if (kk > 4) {
    gx += kC2[0] * y * db[4];
    gy += kC2[0] * x * db[4];
    gy += kC2[1] * z * db[5];
    gz += kC2[1] * y * db[5];
    gx += -2.0f * kC2[2] * x * db[6];
    gy += -2.0f * kC2[2] * y * db[6];
    gz += 4.0f * kC2[2] * z * db[6];
    gx += kC2[3] * z * db[7];
    gz += kC2[3] * x * db[7];
    gx += 2.0f * kC2[4] * x * db[8];
    gy += -2.0f * kC2[4] * y * db[8];
  }
  if (kk > 9) {
    gx += 6.0f * kC3[0] * x * y * db[9];
    gy += kC3[0] * (3.0f * xx - 3.0f * yy) * db[9];
    gx += kC3[1] * y * z * db[10];
    gy += kC3[1] * x * z * db[10];
    gz += kC3[1] * x * y * db[10];
    gx += -2.0f * kC3[2] * x * y * db[11];
    gy += kC3[2] * (4.0f * zz - xx - 3.0f * yy) * db[11];
    gz += 8.0f * kC3[2] * y * z * db[11];
    gx += -6.0f * kC3[3] * x * z * db[12];
    gy += -6.0f * kC3[3] * y * z * db[12];
    gz += kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy) * db[12];
    gx += kC3[4] * (4.0f * zz - 3.0f * xx - yy) * db[13];
    gy += -2.0f * kC3[4] * x * y * db[13];
    gz += 8.0f * kC3[4] * x * z * db[13];
    gx += 2.0f * kC3[5] * x * z * db[14];
    gy += -2.0f * kC3[5] * y * z * db[14];
    gz += kC3[5] * (xx - yy) * db[14];
    gx += kC3[6] * (3.0f * xx - 3.0f * yy) * db[15];
    gy += -6.0f * kC3[6] * x * y * db[15];
  }
  g[0] = gx;
  g[1] = gy;
  g[2] = gz;
}

__global__ void __launch_bounds__(kThreads)
    preprocess2d_backward_kernel(const float* __restrict__ means,
                                 const float* __restrict__ log_scales,
                                 const float* __restrict__ quats,
                                 const float* __restrict__ opacities,
                                 const float* __restrict__ sh, const float* __restrict__ view,
                                 const float* __restrict__ cam_pos,
                                 const float* __restrict__ tan_fovx,
                                 const float* __restrict__ tan_fovy,
                                 const float* __restrict__ d_table, int n, int width,
                                 int height, int degree, int clamped, float scale_modifier,
                                 float* __restrict__ d_means, float* __restrict__ d_log_scales,
                                 float* __restrict__ d_quats, float* __restrict__ d_opacities,
                                 float* __restrict__ d_sh) {
  __shared__ Cam cam;
  if (threadIdx.x == 0) load_cam(cam, view, cam_pos, tan_fovx, tan_fovy, width, height);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Terms t;
  forward_terms(t, cam, means, log_scales, quats, opacities, sh, i, degree, scale_modifier);
  const long long nn = n;
  float g[kSurfelRows];
  for (int k = 0; k < kSurfelRows; ++k) g[k] = d_table[k * nn + i];

  d_opacities[i] = g[11] * t.op * (1.0f - t.op);

  // The colour: the clamp's mask, the coefficients, the basis, the direction.
  const int kk = (degree + 1) * (degree + 1);
  float dc[3];
  for (int ch = 0; ch < 3; ++ch) {
    dc[ch] = (ch < clamped && t.raw[ch] < 0.0f) ? 0.0f : g[12 + ch];
  }
  float db[16];
  const long long row = 48 * static_cast<long long>(i);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const bool used = k < kk;
      d_sh[row + 3 * k + ch] = used ? dc[ch] * t.basis[k] : 0.0f;
      if (used) acc += dc[ch] * sh[row + 3 * k + ch];
    }
    db[k] = acc;
  }
  float ddn[3];
  sh_basis_backward(t.dn[0], t.dn[1], t.dn[2], db, kk, ddn);
  const float proj = ddn[0] * t.dn[0] + ddn[1] * t.dn[1] + ddn[2] * t.dn[2];
  float dp[3];
  for (int a = 0; a < 3; ++a) dp[a] = (ddn[a] - t.dn[a] * proj) * t.dinv;

  // c = (Nx, Ny) / safe; safe = d33 where d33 < 0.
  float dtu[3] = {g[0], g[1], g[2]}, dtv[3] = {g[3], g[4], g[5]}, dtw[3] = {g[6], g[7], g[8]};
  const float dnx = g[9] / t.safe, dny = g[10] / t.safe;
  const float dd = t.d33 < 0.0f ? -(g[9] * (t.nx / t.safe) + g[10] * (t.ny / t.safe)) / t.safe
                                : 0.0f;
  dtu[0] += 9.0f * t.tw[0] * dnx;
  dtu[1] += 9.0f * t.tw[1] * dnx;
  dtu[2] += -t.tw[2] * dnx;
  dtv[0] += 9.0f * t.tw[0] * dny;
  dtv[1] += 9.0f * t.tw[1] * dny;
  dtv[2] += -t.tw[2] * dny;
  dtw[0] += 9.0f * (t.tu[0] * dnx + t.tv[0] * dny) + 18.0f * t.tw[0] * dd;
  dtw[1] += 9.0f * (t.tu[1] * dnx + t.tv[1] * dny) + 18.0f * t.tw[1] * dd;
  dtw[2] += -(t.tu[2] * dnx + t.tv[2] * dny) - 2.0f * t.tw[2] * dd;

  // T's columns K a, K b, K p_cam: the transposed K.
  float dcol[3][3];
  for (int j = 0; j < 3; ++j) {
    dcol[j][0] = cam.fx * dtu[j];
    dcol[j][1] = cam.fy * dtv[j];
    dcol[j][2] = cam.cx * dtu[j] + cam.cy * dtv[j] + dtw[j];
  }
  // a = s_u ax[0], b = s_v ax[1], the normal sign ax[2]; ax[j] = R_cw R[:, j].
  float dax[3][3];
  float ds[2];
  for (int j = 0; j < 2; ++j) {
    ds[j] = dcol[j][0] * t.ax[j][0] + dcol[j][1] * t.ax[j][1] + dcol[j][2] * t.ax[j][2];
    for (int a = 0; a < 3; ++a) dax[j][a] = t.s[j] * dcol[j][a];
  }
  for (int a = 0; a < 3; ++a) dax[2][a] = t.sign * g[15 + a];
  const float* v = cam.view;
  float dr[3][3];  // d R[row][col]
  for (int j = 0; j < 3; ++j) {
    for (int r = 0; r < 3; ++r) {
      dr[r][j] = v[r] * dax[j][0] + v[4 + r] * dax[j][1] + v[8 + r] * dax[j][2];
    }
  }
  for (int a = 0; a < 3; ++a) {
    dp[a] += v[a] * dcol[2][0] + v[4 + a] * dcol[2][1] + v[8 + a] * dcol[2][2];
  }
  for (int a = 0; a < 3; ++a) d_means[3 * i + a] = dp[a];
  for (int j = 0; j < 2; ++j) d_log_scales[2 * i + j] = ds[j] * t.s[j];

  // R of the unit quaternion, then its normalisation q * rsqrt(|q|^2 + eps).
  const float w = t.qn[0], x = t.qn[1], y = t.qn[2], z = t.qn[3];
  float dq[4];
  dq[0] = 2.0f * (-z * dr[0][1] + y * dr[0][2] + z * dr[1][0] - x * dr[1][2] - y * dr[2][0] +
                  x * dr[2][1]);
  dq[1] = 2.0f * (y * dr[0][1] + z * dr[0][2] + y * dr[1][0] - 2.0f * x * dr[1][1] -
                  w * dr[1][2] + z * dr[2][0] + w * dr[2][1] - 2.0f * x * dr[2][2]);
  dq[2] = 2.0f * (-2.0f * y * dr[0][0] + x * dr[0][1] + w * dr[0][2] + x * dr[1][0] +
                  z * dr[1][2] - w * dr[2][0] + z * dr[2][1] - 2.0f * y * dr[2][2]);
  dq[3] = 2.0f * (-2.0f * z * dr[0][0] - w * dr[0][1] + x * dr[0][2] + w * dr[1][0] -
                  2.0f * z * dr[1][1] + y * dr[1][2] + x * dr[2][0] + y * dr[2][1]);
  const float qdot = dq[0] * t.q[0] + dq[1] * t.q[1] + dq[2] * t.q[2] + dq[3] * t.q[3];
  const float q3 = t.qinv * t.qinv * t.qinv;
  for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = dq[k] * t.qinv - t.q[k] * qdot * q3;
}

unsigned blocks(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tpusplat_preprocess2d(const void* means, const void* log_scales, const void* quats,
                                     const void* opacities, const void* sh, const void* alive,
                                     const void* view, const void* cam_pos, const void* tan_fovx,
                                     const void* tan_fovy, int n, int width, int height,
                                     int tile_w, int tile_h, int tiles_x, int tiles_y,
                                     int degree, int clamp_mode, float scale_modifier,
                                     float z_near, float alpha_min, void* out, void* stream) {
  if (n == 0) return 0;
  preprocess2d_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(log_scales),
      static_cast<const float*>(quats), static_cast<const float*>(opacities),
      static_cast<const float*>(sh), static_cast<const bool*>(alive),
      static_cast<const float*>(view), static_cast<const float*>(cam_pos),
      static_cast<const float*>(tan_fovx), static_cast<const float*>(tan_fovy), n, width,
      height, tile_w, tile_h, tiles_x, tiles_y, degree, clamp_mode, scale_modifier, z_near,
      alpha_min, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpusplat_preprocess2d_backward(
    const void* means, const void* log_scales, const void* quats, const void* opacities,
    const void* sh, const void* view, const void* cam_pos, const void* tan_fovx,
    const void* tan_fovy, const void* d_table, int n, int width, int height, int degree,
    int clamped, float scale_modifier, void* d_means, void* d_log_scales, void* d_quats,
    void* d_opacities, void* d_sh, void* stream) {
  if (n == 0) return 0;
  preprocess2d_backward_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(log_scales),
      static_cast<const float*>(quats), static_cast<const float*>(opacities),
      static_cast<const float*>(sh), static_cast<const float*>(view),
      static_cast<const float*>(cam_pos), static_cast<const float*>(tan_fovx),
      static_cast<const float*>(tan_fovy), static_cast<const float*>(d_table), n, width, height,
      degree, clamped, scale_modifier, static_cast<float*>(d_means),
      static_cast<float*>(d_log_scales), static_cast<float*>(d_quats),
      static_cast<float*>(d_opacities), static_cast<float*>(d_sh));
  return static_cast<int>(cudaGetLastError());
}
