"""The whole training step's share of the peak of the cards it uses: the
operations a step needs (the work model, from the reference's pair counts)
over the time a step takes as the loop runs untraced (the window's untraced
rest, on the host clock; rank 0's, in a run of several cards), over the
cards' float32 peak (``chips`` times one card's), in percent."""

from splatbench import workmodel as wm


def read(run):
    t, w = run.trace, run.work
    if t is None or not t.device or not w or t.unit_s_untraced is None:
        return None
    ops = wm.train_step_ops(w["alive"], w["slots"], w, run.pixels)
    return 100.0 * ops / t.unit_s_untraced / (run.chips * wm.PEAK_FP32_FLOPS)
