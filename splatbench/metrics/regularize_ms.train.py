"""The device time of the surfel step's regularizers a step, in ms: the
depth distortion and the normal consistency, forward (from the
``regularize`` stamp to the next) and backward (from ``regularize_bwd`` to
the next), inside the step's graph replay, over the window's untraced tail
(``splatbench/stages.py``). None where the program stamps neither."""

from splatbench import stages


def read(run):
    fwd, bwd = stages.stage_ms(run, "regularize"), stages.stage_ms(run, "regularize_bwd")
    if fwd is None or bwd is None:
        return None
    return fwd + bwd
