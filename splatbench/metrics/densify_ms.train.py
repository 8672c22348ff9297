"""The densify round's device time, in ms: from its ``densify`` stamp to
its ``end`` inside the round's graph replay, the mean over the window's
rounds (``splatbench/densify_stages.py``). None where no round ran."""

import statistics

from splatbench import densify_stages


def read(run):
    ms = densify_stages.round_ms(run)
    return statistics.mean(ms) if ms else None
