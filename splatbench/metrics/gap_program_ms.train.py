"""The part of the gap a step, in ms, during which the host was inside a span
of the program (``tpusplat_torch.trace``), mapped onto the device clock by
the tracer's anchor; the rest of the gap the host spent in the harness
(``splatbench/stages.py``)."""

from splatbench import stages


def read(run):
    return stages.value(run, "gap_program_ms")
