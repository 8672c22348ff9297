"""The device's busy time a frame, in ms: the union of the kernel and copy
intervals of the traced window over the frames traced. Device time alone, so
it holds steady where the host clock's end-to-end numbers spread from run
to run with the host's share of the loop."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.units:
        return None
    return 1e3 * t.busy_s() / t.units
