"""The forward blend kernel's share of its roofline: the least time its
inputs need (the work model's operations and bytes, from the reference's
pair counts) over its mean device time by name in the trace, in percent."""

from splatbench import workmodel as wm

KERNEL = "(anonymous namespace)::forward_kernel("


def read(run):
    t, w = run.trace, run.work
    if t is None or not w:
        return None
    seconds, launches = t.kernel_s(KERNEL)
    if launches == 0:
        return None
    ops, nbytes = wm.blend_fwd(w, w["visible"], run.pixels)
    return 100.0 * wm.bound_s(ops, nbytes) / (seconds / launches)
