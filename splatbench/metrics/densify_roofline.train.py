"""The densify round's share of its roofline: the least time the window's
rounds need (``splatbench/workmodel_densify.py``, from each round's
counters: the statistics, scales, opacities and alive flag of every slot,
and the rows granted, split and pruned) over their device time, in
percent. None where no round ran or the port gives no counters."""

from splatbench import densify_stages
from splatbench import workmodel_densify as wd


def read(run):
    ms = densify_stages.round_ms(run)
    counts = run.rounds["counts"] if ms else None
    if not counts or len(counts) != len(ms):
        return None
    least = sum(wd.round_bound_s(run.conf["gaussians"], c) for c in counts)
    return 100.0 * least / (sum(ms) / 1e3)
