"""Host ms of the program span ``stage::material`` (the staged material: the
attachments sampled at the vertices, then ``shade``), median over the traced
frames (``harness/spans.py``); None where the material runs in the mesh
kernel, as on the planar cell."""

from harness import spans


def read(t):
    return spans.span_ms(t, "stage::material")
