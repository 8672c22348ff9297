"""The surfel preprocess kernel's share of its roofline in a training step:
the least time its surfels need (``workmodel_2dgs``: bytes bind it) over its
mean device time by name in the trace, in percent."""

from splatbench import workmodel_2dgs as wm2

KERNEL = "(anonymous namespace)::preprocess2d_kernel("


def read(run):
    w = run.work
    if not w:
        return None
    return wm2.kernel_share(run, KERNEL, *wm2.preprocess_fwd(w["alive"]))
