"""The work model of a 2D Gaussian Splatting step (``train_2dgs`` cells):
float32 operations and bytes that the inputs of a step need, whatever
implements them, held against ``workmodel.py``'s published peaks.

Counts come from the inputs alone: surfels alive and visible, pixels,
parameters, and the (pixel, surfel) pairs that the blend contract evaluates
and that contribute for these inputs, which the plain reference counts
(``reference_2dgs._blend``): a pair is *evaluated* where it passes the
alpha test while the pixel is not yet saturated, and *contributes* where it
also adds to the maps. Work an implementation repeats (the backward's
recomputed pair test, a second walk of a tile, the staging of the cull's
box) is not counted, so a kernel that does less than the inputs need cannot
read above 100%.

Operations per unit, with their derivation (a multiply-add counts 2, an
exp, log, sqrt, min or division 1):

* preprocess forward, per alive surfel: the quaternion normalised 12, its
  rotation 36, the scales 4, the centre in the camera frame 18, the three
  axes in the camera frame 45, the two scaled 6, T's rows through K 18, the
  normal's turn 8, the 3-sigma dual conic's centre 19, the tile box (the
  cutoff 4, the conic at it 5, its centre 14, its half-extents 16, the
  filter's radius 2, the union 8, the tile box 16) 65, opacity 4, SH degree
  3: direction 9, basis 35, colour 99, clamp 1. 379.
* preprocess backward: twice the forward, autograd's usual ratio for an
  elementwise chain. 758.
* blend forward, per evaluated pair: k and l 12, h = k x l 9, (u, v) 2,
  the grazing test (the normal against the pixel's ray 4, the test 1) 5, rho3 3,
  rho2 6, the min, the scale and the exp 3, z 4, the opacity product 1, the
  clamp 1, three tests 3 = 49; per contributing pair: 1 -
  alpha, T f and its test 3, the weight 1, m 3, the distortion's term 8,
  colour 6, alpha 1, depth 2, normal 6, the running sums M1 and M2 4, the
  transmittance 1 = 35.
* blend backward, per contributing pair (the recomputed test not counted):
  f, T f and 1 / f 3, the transmittance's term 1, the weight 1, m 3, the
  weight's cotangent G 21, the running dot 2, d alpha 5, the colour and
  normal gradients 6, dz 9, the clamp's pass, d op and d rho 3, the
  filter's centre 6, d u and d v 8, d h 7, d k and d l 18, the T rows 21,
  the 18 sums over the tile 18. 132.
* loss forward, per pixel: the photometric loss on 3 channels
  (``workmodel.LOSS_FWD`` each), and the regularizers: the expected depth
  2, its point 5, the differences 6, the cross product 9, the normalising
  9, the consistency 6, the two means 2 = 39. Backward twice that.
* Adam, per parameter (58 a surfel: means 3, log-scales 2, quaternion 4,
  opacity 1, SH 48): ``workmodel.ADAM``; the statistics
  ``workmodel.STATS`` a surfel.

Bytes count each input once and each output once: the forward blend reads
18 float32 rows of each visible surfel and writes 48 bytes a pixel (9 maps,
T, the totals M1 and M2); the backward reads the rows, 88 bytes a pixel
(the maps, T, the totals and their 10 cotangents) and writes 18 float32
gradients of each visible surfel; the preprocess reads 233 bytes a surfel
(means 12, log-scales 8, quaternion 16, opacity 4, SH 192, alive 1) and
writes 100 (aabb 16, the 18-row table 72, depth, radius, tile count 12); its
backward reads 232 (no alive) and the table's gradient, 72, and writes 232.
"""

from __future__ import annotations

from splatbench import workmodel as wm

PEAK_FP32_FLOPS, PEAK_BYTES = wm.PEAK_FP32_FLOPS, wm.PEAK_BYTES
PREPROCESS_FWD = 379
PREPROCESS_BWD = 758
BLEND_FWD_EVAL, BLEND_FWD_CONTRIB = 49, 35
BLEND_BWD_CONTRIB = 132
REG_FWD, REG_BWD = 39, 78
PARAMS_PER_SURFEL = 3 + 2 + 4 + 1 + 48
ATTR_BYTES = 18 * 4
PREPROCESS_FWD_BYTES = 233 + 100
PREPROCESS_BWD_BYTES = 232 + 72 + 232


def blend_fwd(pairs: dict, visible: float, pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one forward blend."""
    ops = BLEND_FWD_EVAL * pairs["evaluated"] + BLEND_FWD_CONTRIB * pairs["contributing"]
    return ops, ATTR_BYTES * visible + 48 * pixels


def blend_bwd(pairs: dict, visible: float, pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one backward blend."""
    return BLEND_BWD_CONTRIB * pairs["contributing"], 2 * ATTR_BYTES * visible + 88 * pixels


def preprocess_fwd(alive: float) -> tuple[float, float]:
    return PREPROCESS_FWD * alive, PREPROCESS_FWD_BYTES * alive


def preprocess_bwd(alive: float) -> tuple[float, float]:
    return PREPROCESS_BWD * alive, PREPROCESS_BWD_BYTES * alive


def train_step_ops(alive: int, slots: int, pairs: dict, pixels: int) -> float:
    """A training step: preprocess and blend both ways, the photometric
    loss both ways on 3 channels and the regularizers, Adam on every
    slot's parameters and the statistics."""
    return (alive * (PREPROCESS_FWD + PREPROCESS_BWD)
            + blend_fwd(pairs, 0, pixels)[0] + blend_bwd(pairs, 0, pixels)[0]
            + pixels * (3 * (wm.LOSS_FWD + wm.LOSS_BWD) + REG_FWD + REG_BWD)
            + slots * (PARAMS_PER_SURFEL * wm.ADAM + wm.STATS))


def kernel_share(run, symbol: str, ops: float, nbytes: float):
    """A kernel's share of its roofline in percent: ``workmodel.bound_s``
    over its mean device time by name in the trace; None without a trace
    or a launch."""
    t = run.trace
    if t is None:
        return None
    seconds, launches = t.kernel_s(symbol)
    if launches == 0:
        return None
    return 100.0 * wm.bound_s(ops, nbytes) / (seconds / launches)
