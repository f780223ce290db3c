"""The device span of one ``Terrain.render_image``: from the start of its
first device operation to the end of its last (profiler, between marker
kernels), median over the traced frames."""

from harness import layers


def read(t):
    spans = [(max(e for _, e, _ in f["render"]) - min(s for s, _, _ in f["render"])) / 1e3
             for f in t["frames"] if f["render"]]
    return layers.median(spans)
