"""The whole surfel training step's share of the card's float32 peak: the
operations a step needs (``workmodel_2dgs``, from the reference's pair
counts) over the time a step takes as the loop runs untraced (the window's
untraced rest, on the host clock), over the peak, in percent."""

from splatbench import workmodel_2dgs as wm2


def read(run):
    t, w = run.trace, run.work
    if t is None or not t.device or not w or t.unit_s_untraced is None:
        return None
    ops = wm2.train_step_ops(w["alive"], w["slots"], w, run.pixels)
    return 100.0 * ops / t.unit_s_untraced / (run.chips * wm2.PEAK_FP32_FLOPS)
