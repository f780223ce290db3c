"""Device ms of the program span ``raster::bin_sort`` (the triangles binned
by one sort), from its CUDA event pair, median over the traced frames
(``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "raster::bin_sort", "device_ms")
