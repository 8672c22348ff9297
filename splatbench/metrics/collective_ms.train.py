"""Rank 0's collectives a traced step, in ms: the summed device time of
the kernels whose name holds ``nccl`` (NCCL's all-gather, all-to-all,
send/receive of the halo, all-reduce), over the steps traced. An NCCL
kernel starts when its rank reaches the collective and ends when every peer
has, so this includes the time rank 0 waits for the slowest strip."""

from splatbench import trace as tr


def read(run):
    t = run.trace
    if t is None or not t.device or not t.units:
        return None
    seconds, launches = t.kernel_s(tr.COLLECTIVE)
    if launches == 0:
        return None
    return 1e3 * seconds / t.units
