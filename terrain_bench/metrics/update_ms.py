"""``Terrain.update`` from the call to a synchronize, host clock, median over
the traced frames (each followed by its own synchronize, then the render)."""

from harness import layers


def read(t):
    return layers.median(t["update_ms"])
