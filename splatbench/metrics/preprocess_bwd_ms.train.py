"""The device time of preprocess's backward (autograd through the projection
and the SH colour) a step, in ms: from its ``preprocess_bwd`` stamp to the
``adam`` stamp inside the step's graph replay, over the window's untraced
tail (``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "preprocess_bwd")
