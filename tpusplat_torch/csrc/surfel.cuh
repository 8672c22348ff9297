// The per-(surfel, pixel) ray-splat test of 2D Gaussian Splatting, shared by
// the forward and the backward surfel blend kernels (rasterize2d_forward.cu,
// rasterize2d_backward.cu) so that the backward's walk recomputes the
// forward's transmittance from the same arithmetic, and the pixel box that
// both kernels cull (surfel, warp) pairs with and that preprocess2d.cu bins
// tiles with. Plain versions: tpusplat_torch/ops/surfel.py::pair_terms,
// pixel_box.
//
// A surfel's slab rows (ops/surfel.py's table): T_u 0-2, T_v 3-5, T_w 6-8,
// the filter's centre c 9-10, opacity 11, colour 12-14, normal 15-17. At
// pixel (x, y): k = x T_w - T_u, l = y T_w - T_v, h = k x l, (u, v) =
// (h_x, h_y) / h_z, rho3 = u^2 + v^2, rho2 = 2 |x - c|^2,
// G = exp(-min(rho3, rho2) / 2), z = T_w . (u, v, 1) where rho3 <= rho2 and
// the centre's depth T_w,z where the filter wins (the disk seen nearly edge-on,
// where the intersection's depth is ill-conditioned), alpha = min(alpha_max,
// op G); the pair is tested where h_z != 0 and z >= near. Where the pixel's ray
// r = ((x - c_x) / f_x, (y - c_y) / f_y, 1) grazes the disk's plane,
// |n . r| < kGrazing |r| (within about half a degree of edge-on), rho3 is taken
// as +inf, so the filter's term and the centre's depth hold: there k and l
// are mostly cancellation, and the disk's term and its gradients (up to 1e3
// times the other surfels') are rounding noise.
//
// Every product and sum below is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, IEEE division): nvcc never contracts them into FMAs, so the
// two kernels, compiled apart, get the same bits for the same pair.
#pragma once

#include <math.h>

constexpr int kSurfelRows = 18;
constexpr int kMaps = 9;  // colour 3, alpha, depth sum, normal 3, distortion
constexpr float kGrazing = 1e-2f;  // ops/surfel.py GRAZING: the cosine

namespace surfel {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Pair {
  float kx, ky, kz, lx, ly, lz;
  float hz;  // h_z, 1 where it is 0
  float u, v;
  float z;
  bool use3;  // rho3 <= rho2 (rho3 +inf where the ray grazes): G follows the disk
  float g;    // exp(-rho / 2)
  float alpha_raw, alpha;
  bool ok;  // h_z != 0 and z >= near
};

// Each pixel's ray (r_x, r_y) and kGrazing |r| from the intrinsics (f_x, f_y,
// c_x, c_y) (ops/surfel.py::pixel_rays).
__device__ __forceinline__ void pixel_ray(const float* intr, float px, float py, float& rx,
                                          float& ry, float& graze) {
  rx = __fdiv_rn(sub(px, intr[2]), intr[0]);
  ry = __fdiv_rn(sub(py, intr[3]), intr[1]);
  graze = mul(kGrazing, __fsqrt_rn(add(add(mul(rx, rx), mul(ry, ry)), 1.0f)));
}

// Row r of staged instance j: b[r * stride + j]; the pixel (px, py) and its
// ray from pixel_ray.
__device__ __forceinline__ Pair pair(const float* b, int stride, int j, float px, float py,
                                     float rx, float ry, float graze, float near,
                                     float alpha_max) {
  Pair r;
  const float tw0 = b[6 * stride + j], tw1 = b[7 * stride + j], tw2 = b[8 * stride + j];
  r.kx = sub(mul(px, tw0), b[0 * stride + j]);
  r.ky = sub(mul(px, tw1), b[1 * stride + j]);
  r.kz = sub(mul(px, tw2), b[2 * stride + j]);
  r.lx = sub(mul(py, tw0), b[3 * stride + j]);
  r.ly = sub(mul(py, tw1), b[4 * stride + j]);
  r.lz = sub(mul(py, tw2), b[5 * stride + j]);
  const float hx = sub(mul(r.ky, r.lz), mul(r.kz, r.ly));
  const float hy = sub(mul(r.kz, r.lx), mul(r.kx, r.lz));
  const float hz = sub(mul(r.kx, r.ly), mul(r.ky, r.lx));
  const bool nz = hz != 0.0f;
  r.hz = nz ? hz : 1.0f;
  r.u = __fdiv_rn(hx, r.hz);
  r.v = __fdiv_rn(hy, r.hz);
  const float ndr =
      add(add(mul(b[15 * stride + j], rx), mul(b[16 * stride + j], ry)), b[17 * stride + j]);
  const bool grazing = fabsf(ndr) < graze;
  const float rho3 =
      grazing ? __int_as_float(0x7f800000) : add(mul(r.u, r.u), mul(r.v, r.v));
  const float dx = sub(b[9 * stride + j], px), dy = sub(b[10 * stride + j], py);
  const float rho2 = mul(2.0f, add(mul(dx, dx), mul(dy, dy)));
  r.use3 = rho3 <= rho2;
  r.g = expf(mul(-0.5f, r.use3 ? rho3 : rho2));
  r.z = r.use3 ? add(add(mul(tw0, r.u), mul(tw1, r.v)), tw2) : tw2;
  r.alpha_raw = mul(b[11 * stride + j], r.g);
  r.alpha = fminf(alpha_max, r.alpha_raw);
  r.ok = nz && r.z >= near;
  return r;
}

__device__ __forceinline__ bool finite(double x) { return fabs(x) <= 1.7976931348623157e308; }

// The box [x0, x1] x [y0, y1] of the pixels at which a surfel can reach
// alpha_min (ops/surfel.py::pixel_box): its disk's box out to k sigmas,
// k^2 = max(9, 2 ln(op / alpha_min)), from the dual conic T diag(k^2, k^2,
// -1) T^T, joined with its filter's circle of radius k / sqrt(2) about c;
// computed in double. Returns false, and an infinite box, where the disk
// out to k sigmas reaches the camera's plane (C*_33 >= 0) or an input is
// not finite. `v` holds the slab's first 12 rows.
__device__ __forceinline__ bool pixel_box(const float (&v)[12], float alpha_min, double& x0,
                                          double& x1, double& y0, double& y1) {
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  x0 = y0 = -inf;
  x1 = y1 = inf;
  const double op = v[11];
  const double k2 = fmax(9.0, 2.0 * log(fmax(op, 1e-30) / static_cast<double>(alpha_min)));
  const double tu0 = v[0], tu1 = v[1], tu2 = v[2], tv0 = v[3], tv1 = v[4], tv2 = v[5];
  const double tw0 = v[6], tw1 = v[7], tw2 = v[8];
  const double c33 = k2 * (tw0 * tw0 + tw1 * tw1) - tw2 * tw2;
  if (!(c33 < 0.0) || !finite(k2)) return false;
  const double ex = (k2 * (tu0 * tw0 + tu1 * tw1) - tu2 * tw2) / c33;
  const double ey = (k2 * (tv0 * tw0 + tv1 * tw1) - tv2 * tw2) / c33;
  const double hx = sqrt(fmax(ex * ex - (k2 * (tu0 * tu0 + tu1 * tu1) - tu2 * tu2) / c33, 1e-4));
  const double hy = sqrt(fmax(ey * ey - (k2 * (tv0 * tv0 + tv1 * tv1) - tv2 * tv2) / c33, 1e-4));
  const double rf = sqrt(k2 * 0.5);
  const double cx = v[9], cy = v[10];
  const double a0 = fmin(ex - hx, cx - rf), a1 = fmax(ex + hx, cx + rf);
  const double b0 = fmin(ey - hy, cy - rf), b1 = fmax(ey + hy, cy + rf);
  if (!(finite(a0) && finite(a1) && finite(b0) && finite(b1))) return false;
  x0 = a0;
  x1 = a1;
  y0 = b0;
  y1 = b1;
  return true;
}

// The blend kernels' cull box of a staged instance: pixel_box with a margin
// of one pixel and a thousandth of its width on each side, for the float32
// rounding of the pair's terms; infinite (the cull off) where pixel_box
// gives none.
__device__ __forceinline__ void cull_box(const float (&v)[12], float alpha_min, float& x0,
                                         float& x1, float& y0, float& y1) {
  double a0, a1, b0, b1;
  if (!pixel_box(v, alpha_min, a0, a1, b0, b1)) {
    const float inf = __int_as_float(0x7f800000);
    x0 = y0 = -inf;
    x1 = y1 = inf;
    return;
  }
  const double mx = 1.0 + 1e-3 * (a1 - a0), my = 1.0 + 1e-3 * (b1 - b0);
  x0 = static_cast<float>(a0 - mx);
  x1 = static_cast<float>(a1 + mx);
  y0 = static_cast<float>(b0 - my);
  y1 = static_cast<float>(b1 + my);
}

}  // namespace surfel
