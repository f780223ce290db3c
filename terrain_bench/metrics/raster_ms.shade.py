"""Device ms of the program span ``raster::shade`` (after the raster:
per-pixel normals, texturing, interpolation and lighting), from its CUDA
event pair, median over the traced frames (``harness/spans.py``)."""

from harness import spans


def read(t):
    return spans.span_ms(t, "raster::shade", "device_ms")
