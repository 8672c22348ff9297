"""The device time of the write-back of the donated state into its buffers a
step, in ms: from its ``writeback`` stamp to the ``end`` stamp inside the
step's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "writeback")
