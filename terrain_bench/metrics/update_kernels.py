"""Kernels one ``Terrain.update`` launches on the card (copies and fills
left out), median over the traced frames (profiler, between marker
kernels)."""

from harness import layers


def read(t):
    return layers.median([len(layers.kernels(f["update"])) for f in t["frames"]])
