"""An aerial pass over a planar terrain: ``positions`` cameras along a
straight line, descending linearly, each looking along the line and
``pitch_deg`` below the horizon.

The line is ``start_m`` to ``end_m`` along a direction through the
terrain's centre, ``lateral_m`` to its side. The seed draws one of the 8
images of that line under the square's symmetries (4 directions, the side
mirrored), so every seed flies the same geometry over its own terrain, and
the phase of the visiting order.
"""

from __future__ import annotations

import numpy as np

from reference.geometry import view_projection


def cameras(path: dict, cfg: dict, seed: int, aspect: float) -> list:
    """[(eye (3,) f64, view_proj (4, 4) f64)] along the path, in path
    order."""
    rng = np.random.default_rng([int(seed), 101])
    variant = int(rng.integers(8))
    ang = np.pi / 2 * (variant % 4)
    along = np.array([np.cos(ang), 0.0, np.sin(ang)])
    side = np.array([-along[2], 0.0, along[0]]) * (1 if variant < 4 else -1)
    n = int(path["positions"])
    s = np.linspace(path["start_m"], path["end_m"], n)
    alt = np.linspace(path["altitude_m"][0], path["altitude_m"][1], n)
    pitch = np.radians(path["pitch_deg"])
    look = along * np.cos(pitch) + np.array([0.0, -np.sin(pitch), 0.0])
    fov = np.radians(path["fov_y_deg"])
    out = []
    for k in range(n):
        eye = along * s[k] + side * path["lateral_m"] + np.array([0.0, alt[k], 0.0])
        out.append((eye, view_projection(eye, eye + look, fov, aspect)))
    return out
