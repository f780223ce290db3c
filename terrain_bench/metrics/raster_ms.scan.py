"""Device ms of the program span ``raster::scan`` (the per-bin edge tests and
depth race), from its CUDA event pair, median over the traced frames
(``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "raster::scan", "device_ms")
