"""The work model: float32 operations and bytes that the inputs of a step or
a frame need, whatever implements them, and the published peaks they are
held against.

Counts come from the inputs alone: Gaussians alive and visible, pixels,
parameters, and the (pixel, Gaussian) pairs that the blend contract
evaluates for these inputs, which the plain reference counts
(``reference._blend``): a pair is *evaluated* where the pixel lies in the
Gaussian's alpha >= 1/255 footprint, inside its tile box, while the pixel
is not yet saturated; it *contributes* where it also adds colour. Work that
an implementation repeats (a recomputed alpha in the backward, a second
walk of a tile) is not counted, so a kernel that does less than the inputs
need cannot read above 100%.

Operations per unit, with their derivation (a multiply-add counts 2, an
exp, log, sqrt or division 1):

* preprocess forward, per alive Gaussian: the view transform 18, the
  projection to NDC 21, the clamped Jacobian 16, M = J V 18, the 3D
  covariance from scale and quaternion 84 (exp 3, normalise 12, rotation
  36, R S S R^T 33), the 2D covariance 48, det and conic 7, radius and tile
  box 30, opacity 4, SH degree 3: direction 9, basis 35, colour 99. 389.
* preprocess backward: twice the forward, autograd's usual ratio for an
  elementwise chain. 778.
* blend forward, per evaluated pair: dx, dy 2, the quadratic form 9, exp 1,
  opacity 1, clamp 1 = 14; per contributing pair: weight 1, colour 6,
  transmittance 2 = 9.
* blend backward, per contributing pair (3DGS's backward, recomputation
  of alpha not counted): transmittance restored 2, the running colour 6,
  d alpha 9, times T 1, d colour 7, d G 1, G dx, G dy 2, d power / d delta
  6, d uv 2, d conic 9, d opacity 2. 47.
* loss forward, per pixel and channel: L1 3; SSIM as a separable 11-tap
  filter of 5 maps (x, y, x^2, y^2, xy), two passes of 11 multiply-adds,
  220, and the map 20. 243. Backward twice that: 486.
* Adam, per parameter: moments 7, bias corrections 2, sqrt 1, eps 1,
  division 1, the learning-rate step 2. 14.
* densification statistics, per Gaussian per step: the means' gradient
  norm 6, the sums 2, the radius max 1. 9.

Bytes count each input once and each output once: a blend reads 9 float32
attributes of each visible Gaussian and writes 16 bytes a pixel (colour and
transmittance); the backward reads the attributes, 12 bytes a pixel of
image gradient and 4 of transmittance, and writes 9 float32 gradients of
each visible Gaussian.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at the full 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PREPROCESS_FWD = 389
PREPROCESS_BWD = 778
BLEND_FWD_EVAL, BLEND_FWD_CONTRIB = 14, 9
BLEND_BWD_CONTRIB = 47
LOSS_FWD, LOSS_BWD = 243, 486
ADAM = 14
STATS = 9
PARAMS_PER_GAUSSIAN = 3 + 3 + 4 + 1 + 48
ATTR_BYTES = 9 * 4


def blend_fwd(pairs: dict, visible: float, pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one forward blend."""
    ops = BLEND_FWD_EVAL * pairs["evaluated"] + BLEND_FWD_CONTRIB * pairs["contributing"]
    return ops, ATTR_BYTES * visible + 16 * pixels


def blend_bwd(pairs: dict, visible: float, pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one backward blend."""
    return (BLEND_BWD_CONTRIB * pairs["contributing"],
            2 * ATTR_BYTES * visible + 16 * pixels)


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds the card can take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


def frame_ops(alive: int, pairs: dict, pixels: int) -> float:
    """A forward frame: preprocess and the blend."""
    return alive * PREPROCESS_FWD + blend_fwd(pairs, 0, pixels)[0]


def train_step_ops(alive: int, slots: int, pairs: dict, pixels: int) -> float:
    """A training step: preprocess and blend both ways, the loss both ways
    on 3 channels, Adam on every slot's parameters and the statistics."""
    return (alive * (PREPROCESS_FWD + PREPROCESS_BWD)
            + blend_fwd(pairs, 0, pixels)[0] + blend_bwd(pairs, 0, pixels)[0]
            + 3 * pixels * (LOSS_FWD + LOSS_BWD)
            + slots * (PARAMS_PER_GAUSSIAN * ADAM + STATS))
