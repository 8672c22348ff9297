"""The loss layer's time: ``gs_loss`` forward and backward at the cell's
frame, CUDA events around each call from the harness, mean in ms."""


def read(run):
    ms = run.spans.get("loss")
    return sum(ms) / len(ms) if ms else None
