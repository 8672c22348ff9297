"""The device time of the blend stage (the attribute gather, the forward blend
and the aux outputs) a frame, in ms: from its ``blend`` stamp to the ``end``
stamp inside the frame's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "blend")
