"""The device time of the preprocess stage (projection, covariance, SH colour,
tile boxes) a step, in ms: from its ``preprocess`` stamp to the ``binning``
stamp inside the step's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "preprocess")
