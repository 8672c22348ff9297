"""The device time of the optimizer stage (gated Adam, the densify statistics,
the gate) a step, in ms: from its ``adam`` stamp to the ``writeback`` stamp
inside the step's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "adam")
