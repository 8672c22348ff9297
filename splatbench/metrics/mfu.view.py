"""The whole frame's share of the card's float32 peak: the operations a
frame needs (preprocess and the forward blend, from the reference's pair
counts) over the time a frame takes as the loop runs untraced (the window's
untraced rest, on the host clock), in percent."""

from splatbench import workmodel as wm


def read(run):
    t, w = run.trace, run.work
    if t is None or not t.device or not w or t.unit_s_untraced is None:
        return None
    return 100.0 * wm.frame_ops(w["alive"], w, run.pixels) / t.unit_s_untraced \
        / wm.PEAK_FP32_FLOPS
