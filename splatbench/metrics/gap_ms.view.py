"""The gap a frame, in ms: from one replay's ``end`` stamp to the next replay's
first, on the device clock (the copies out and in, and the device idle),
over the window's untraced tail (``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.value(run, "gap_ms")
