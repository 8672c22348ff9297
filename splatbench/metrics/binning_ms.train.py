"""The device time of the binning stage (depth sort, instance emission, tile
sort and ranges) a step, in ms: from its ``binning`` stamp to the ``blend``
stamp inside the step's graph replay, over the window's untraced tail
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.stage_ms(run, "binning")
