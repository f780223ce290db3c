"""Host ms of the program span ``update::requests`` (the request scans over
the views), median over the traced frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "update::requests")
