"""Device-idle ms a frame in gaps whose midpoint lies in an ``update::``
program span (the host prologue), median over the traced frames
(``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.idle_ms(t, "update::")
