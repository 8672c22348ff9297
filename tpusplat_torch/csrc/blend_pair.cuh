// The per-(instance, pixel) test of the blend, shared by the forward and the
// backward kernel so that the backward's walk recomputes the forward's
// transmittance from the same expression (render.comp:68-79):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(alpha_max, op e^power)
// with dx = uv.x - px, dy = uv.y - py.
#pragma once

struct BlendPair {
  float dx, dy;
  float power;
  float epow;       // exp(power)
  float alpha_raw;  // op * exp(power), before the clamp
  float alpha;      // min(alpha_max, alpha_raw)
};

__device__ __forceinline__ BlendPair blend_pair(float uvx, float uvy, float ca, float cb,
                                                float cc, float op, float px, float py,
                                                float alpha_max) {
  BlendPair r;
  r.dx = uvx - px;
  r.dy = uvy - py;
  r.power = -0.5f * (ca * r.dx * r.dx + cc * r.dy * r.dy) - cb * r.dx * r.dy;
  r.epow = expf(r.power);
  r.alpha_raw = op * r.epow;
  r.alpha = fminf(alpha_max, r.alpha_raw);
  return r;
}
