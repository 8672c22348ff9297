"""The work model of a densify round: the least bytes that any
implementation of the round must move, given its counts (the port's round
counters: granted, split, pruned), and the least time they take at the
card's peak bandwidth (``workmodel.PEAK_BYTES``).

Every slot: the two statistics read to form the average gradient (8
bytes), the log-scales read for the split and size tests (12), the opacity
read for the opacity prune (4), the alive flag read (1), and the three
statistics written back as zeros (12): 37 bytes. A granted row: its
source's parameters read (59 float32, 236 bytes), written into the granted
slot (236), the slot's alive flag (1) and its two Adam moments zeroed (472).
A split: the source's mean and log-scales written in place (24) and its
moments zeroed (472). A pruned row: its alive flag (1) and its moments
zeroed (472). The screen radius is not read: the screen-size prune is off.

What the round's code happens to move besides (the sort of the
candidates, its index lists, the draws of every slot, whole-tensor
copies) is not counted, so an in-place round that touches only these rows
can read 100% and none can read above it. The operations (a split's
rotation, the draws' hashing, per granted row) are under a thousandth of
the bytes' time at the card's float32 peak, and not counted.
"""

from __future__ import annotations

from splatbench import workmodel as wm

PARAM_BYTES = 4 * wm.PARAMS_PER_GAUSSIAN  # a Gaussian's parameters
MOMENT_BYTES = 2 * PARAM_BYTES  # its two Adam moments
SLOT_BYTES = 8 + 12 + 4 + 1 + 12
GRANTED_BYTES = 2 * PARAM_BYTES + 1 + MOMENT_BYTES
SPLIT_BYTES = 24 + MOMENT_BYTES
PRUNED_BYTES = 1 + MOMENT_BYTES


def round_bytes(slots: int, counts: dict) -> float:
    """Least bytes of one round over ``slots`` slots with the round's
    ``counts`` (``granted``, ``split``, ``pruned``)."""
    return (slots * SLOT_BYTES + counts["granted"] * GRANTED_BYTES
            + counts["split"] * SPLIT_BYTES + counts["pruned"] * PRUNED_BYTES)


def round_bound_s(slots: int, counts: dict) -> float:
    """Least seconds of one round on the card."""
    return wm.bound_s(0.0, round_bytes(slots, counts))
