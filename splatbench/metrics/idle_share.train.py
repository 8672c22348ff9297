"""The device's idle share of the training loop, in percent: 1 - the union
of the kernel and copy intervals of the traced units, over the time those
units take when the loop runs untraced (the rest of the same window, on the
host clock). The tracer costs each graph replay about a millisecond on the
host, which the traced window itself would count as idle."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.untraced_window_s() is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.untraced_window_s())
