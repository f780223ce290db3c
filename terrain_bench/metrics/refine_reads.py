"""The program counter ``refine_reads``: the refinement spill loop's
synchronous host reads of the queue count a frame, median over the traced
frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.counter(t, "refine_reads")
