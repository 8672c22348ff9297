"""How far the busiest rank's own device work a step lies above the mean
over the ranks, in percent: each rank's busy time apart from NCCL's kernels
(the union of its other kernel and copy intervals) over its traced steps.
The strips of a tile-sharded step carry unequal work, and the busiest sets
the pace of every collective after it."""


def read(run):
    per_step = [r["compute_busy_s"] / r["units"] for r in run.ranks
                if r is not None and r["units"] and r["compute_busy_s"] > 0]
    if len(per_step) < 2 or len(per_step) != len(run.ranks):
        return None
    mean = sum(per_step) / len(per_step)
    return 100.0 * (max(per_step) - mean) / mean
