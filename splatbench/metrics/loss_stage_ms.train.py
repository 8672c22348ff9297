"""The device time of the loss stage as the step's graph replays it (L1 and
SSIM, forward and backward) a step, in ms: from its ``loss`` stamp to the
``blend_bwd`` stamp inside the step's graph replay, over the window's
untraced tail (``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "loss")
