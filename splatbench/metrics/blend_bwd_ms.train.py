"""The device time of the backward blend stage (the backward blend kernel, the
gather's gradient: its sort and segment reduce) a step, in ms: from its
``blend_bwd`` stamp to the ``preprocess_bwd`` stamp inside the step's graph
replay, over the window's untraced tail (``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "blend_bwd")
