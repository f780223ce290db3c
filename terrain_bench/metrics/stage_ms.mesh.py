"""Host ms of the program span ``stage::mesh`` (the patch plan, the per-tile
parameters and the mesh kernel's launch, or the staged mesh), median over
the traced frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "stage::mesh")
