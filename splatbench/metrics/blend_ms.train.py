"""The device time of the blend stage (the attribute gather, the forward blend
and the aux outputs) a step, in ms: from its ``blend`` stamp to the ``loss``
stamp inside the step's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "blend")
