"""Device-idle ms a frame in gaps whose midpoint lies in a ``stage::``
program span (the device stage's launches and host reads), median over the
traced frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.idle_ms(t, "stage::")
