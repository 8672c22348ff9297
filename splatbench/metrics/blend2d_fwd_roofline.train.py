"""The forward surfel blend kernel's share of its roofline in a training
step: the least time its inputs need (``workmodel_2dgs``'s operations and
bytes, from the reference's pair counts) over its mean device time by name
in the trace, in percent."""

from splatbench import workmodel_2dgs as wm2

KERNEL = "(anonymous namespace)::forward2d_kernel("


def read(run):
    w = run.work
    if not w:
        return None
    return wm2.kernel_share(run, KERNEL, *wm2.blend_fwd(w, w["visible"], run.pixels))
