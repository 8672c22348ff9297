// The per-warp cull shared by the forward and the backward blend kernels:
// each instance's box of pixels at which it can pass the blend's test
// (pass_extent), the warps' pixel layout with the rectangle that holds each
// warp's pixels (warp_pixels, warp_rect), and the test of a box against a
// rectangle (BOX_MISSES). Plain versions: tpusplat_torch/ops/rasterize.py::
// pass_extent_plain and warp_pixels.
//
// The cull is conservative: it never drops a pair that passes in float32.
// A pair passes where op e^power >= alpha_min and power <= 0. With
// tau = ln(op / alpha_min) and power = -q/2, q = d^T C d, C = [[a, b],
// [b, c]], d = (dx, dy), that is q <= 2 tau; for C positive definite the
// ellipse q <= Q has the box |dx| <= sqrt(Q c / det), |dy| <= sqrt(Q a / det),
// det = a c - b^2. The kernels evaluate power in float32 (blend_pair.cuh):
// its error is at most a few units of 2^-24 times S/2,
// S = |a| dx^2 + |c| dy^2 + 2 |b dx dy|, and S <= kappa q with
// kappa = (1 + |rho|) / (1 - |rho|), rho = b / sqrt(ac); exp and the opacity
// product err by under 1e-6 relative. So a pair that passes in float32 has
// q <= Q = 2 (tau + kTauSlack) / (1 - kPowerErr kappa), with kTauSlack and
// kPowerErr several times those errors. det, tau and the extents are
// computed in double from the float32 inputs, and each half-extent gets a
// margin of one pixel plus kRelMargin of itself, which covers the float32
// rounding of dx and of the box's edges for pixel coordinates below 2^24.
// The cull is off (an infinite box) where an input is not finite,
// alpha_min <= 0, C is not positive definite, or kPowerErr kappa > 1/2
// (b^2 too close to a c for float32 to tell); the box is empty where
// op <= 0 or tau < -kTauSlack, since no pixel then passes. A NaN edge culls
// nothing.
//
// A warp that skips an instance leaves its pixels' state as it is, which is
// what the instance does to every pixel at which it fails the test; so a
// kernel that walks only the instances whose box meets its warp's rectangle
// computes exactly what it computes walking all of them.
#pragma once

constexpr double kTauSlack = 1e-5;
constexpr double kPowerErr = 1e-6;
constexpr double kRelMargin = 1e-3;

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.402823466e38f; }

// The half-extents of the pixel offsets (dx, dy) at which an instance can
// pass the test, margin included (see the note above): +inf where the cull
// is off, -inf where no pixel passes.
__device__ __forceinline__ float2 pass_extent(float ca, float cb, float cc, float op,
                                              float alpha_min) {
  const float inf = __int_as_float(0x7f800000);
  if (!(finite(ca) && finite(cb) && finite(cc) && finite(op)) || !(alpha_min > 0.0f)) {
    return make_float2(inf, inf);
  }
  if (!(op > 0.0f)) return make_float2(-inf, -inf);  // op e^power <= 0 < alpha_min
  const double a = ca, b = cb, c = cc;
  const double det = a * c - b * b;
  if (!(a > 0.0 && c > 0.0 && det > 0.0)) return make_float2(inf, inf);
  const double tau = log(static_cast<double>(op) / static_cast<double>(alpha_min));
  if (tau < -kTauSlack) return make_float2(-inf, -inf);
  const double rho = fabs(b) / sqrt(a * c);
  const double kappa = (1.0 + rho) / (1.0 - rho);
  if (kPowerErr * kappa > 0.5) return make_float2(inf, inf);
  const double q = 2.0 * (fmax(tau, 0.0) + kTauSlack) / (1.0 - kPowerErr * kappa);
  return make_float2(static_cast<float>(sqrt(q * c / det) * (1.0 + kRelMargin) + 1.0),
                     static_cast<float>(sqrt(q * a / det) * (1.0 + kRelMargin) + 1.0));
}

// The warps' pixels. A block has one thread per pixel of its tile; a
// warp's 32 pixels are an 8 x 4 block of the tile where the tile divides
// into such blocks (a 16 x 16 tile into 2 x 4), else 32 consecutive pixels
// in row-major order: a square block meets fewer Gaussians' footprints than
// a strip of the same area. Thread p (lane and warp of the block) gets its
// pixel (lx, ly) in the tile and the tile-local rectangle [x0, x1] x
// [y0, y1] that holds its warp's pixels.
__device__ __forceinline__ void warp_pixels(int p, int lane, int warp, int tile_w, int tile_h,
                                            int& lx, int& ly, int& x0, int& x1, int& y0,
                                            int& y1) {
  if (tile_w % 8 == 0 && tile_h % 4 == 0) {
    x0 = warp % (tile_w / 8) * 8;
    y0 = warp / (tile_w / 8) * 4;
    x1 = x0 + 7;
    y1 = y0 + 3;
    lx = x0 + (lane & 7);
    ly = y0 + (lane >> 3);
  } else {
    const int p0 = p - lane, p1 = p0 + 31;
    y0 = p0 / tile_w;
    y1 = p1 / tile_w;
    x0 = y0 == y1 ? p0 % tile_w : 0;
    x1 = y0 == y1 ? p1 % tile_w : tile_w - 1;
    lx = p % tile_w;
    ly = p / tile_w;
  }
}

// The warp's rectangle in pixel coordinates, for tile (tx, ty) of a window
// whose first tile row is row0: rows are global pixel rows.
__device__ __forceinline__ void warp_rect(int tx, int ty, int tile_w, int tile_h, int row0,
                                          int x0, int x1, int y0, int y1, float& wx0,
                                          float& wx1, float& wy0, float& wy1) {
  wx0 = static_cast<float>(tx * tile_w + x0);
  wx1 = static_cast<float>(tx * tile_w + x1);
  wy0 = static_cast<float>((row0 + ty) * tile_h + y0);
  wy1 = static_cast<float>((row0 + ty) * tile_h + y1);
}

// True where staged instance j's box, box[0, 1, 2, 3 x stride + j] = x low,
// x high, y low, y high, misses the rectangle [wx0, wx1] x [wy0, wy1]; false
// where an edge is NaN. A macro: written as a function, the same test
// compiles the backward kernel to other instructions.
#define BOX_MISSES(box, stride, j, wx0, wx1, wy0, wy1)                             \
  ((box)[0 * (stride) + (j)] > (wx1) || (box)[1 * (stride) + (j)] < (wx0) ||      \
   (box)[2 * (stride) + (j)] > (wy1) || (box)[3 * (stride) + (j)] < (wy0))
