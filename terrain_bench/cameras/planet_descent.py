"""A descent toward a planet: ``positions`` cameras over one surface point,
altitudes log-spaced from ``altitude_m[0]`` to ``altitude_m[1]`` above the
model's highest terrain (``max_height_m``), so no camera is ever inside the
terrain whatever the seed's heights (or, with ``"above": "sphere"``, above
the sphere at height 0), each looking straight down at the planet's
centre.

The surface point is one of the 48 images of ``surface_dir`` under the
cube's symmetries (axis permutations and signs), drawn from the seed, so
every seed descends onto the same place of the cube-sphere's tiling over
its own terrain. ``surface_dir`` stays over 20 degrees from the world's
y axis in every image, the up vector of the view matrix.
"""

from __future__ import annotations

import itertools

import numpy as np

from reference.geometry import view_projection


def cameras(path: dict, cfg: dict, seed: int, aspect: float) -> list:
    """[(eye (3,) f64, view_proj (4, 4) f64)] in path order."""
    rng = np.random.default_rng([int(seed), 102])
    base = np.asarray(path["surface_dir"], np.float64)
    base = base / np.linalg.norm(base)
    images = [np.array(signs) * base[list(perm)]
              for perm in itertools.permutations(range(3))
              for signs in itertools.product((1.0, -1.0), repeat=3)]
    d = images[int(rng.integers(len(images)))]
    m = cfg["model"]
    alt = np.geomspace(path["altitude_m"][0], path["altitude_m"][1], int(path["positions"]))
    fov = np.radians(path["fov_y_deg"])
    out = []
    for a in alt:
        floor = m["max_height_m"] if path.get("above", "peaks") == "peaks" else 0.0
        eye = d * (m["radius_m"] + floor + float(a))
        out.append((eye, view_projection(eye, eye * 0.5, fov, aspect)))
    return out
