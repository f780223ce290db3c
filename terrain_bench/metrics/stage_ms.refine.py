"""Host ms of the program span ``stage::refine`` (refinement: the dense
levels and the spill loop with its reads of the queue count), median over
the traced frames (``harness/spans.py``). The stage is launch-bound, so the
host's pace is the stage's."""

from harness import spans


def read(t):
    return spans.span_ms(t, "stage::refine")
