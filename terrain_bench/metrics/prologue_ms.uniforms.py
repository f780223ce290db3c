"""Host ms of the program span ``update::uniforms`` (per view: the entries,
the height probe, the approximation, the packed uniforms, then their copy
to the device), median over the traced frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "update::uniforms")
