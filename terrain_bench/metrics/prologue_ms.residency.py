"""Host ms of the program span ``update::residency`` (the atlas's residency
and IO, and the uploads of the tiles loaded), median over the traced frames
(``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "update::residency")
