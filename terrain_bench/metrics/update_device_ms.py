"""Device time of the kernels of one ``Terrain.update`` (copies and fills
left out), median over the traced frames (profiler, between marker
kernels)."""

from harness import layers


def read(t):
    return layers.median([sum(e - s for s, e, _ in layers.kernels(f["update"])) / 1e3
                          for f in t["frames"]])
