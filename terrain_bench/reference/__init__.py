"""The plain reference that decides ``correct``: the terrain's frame in
float64 from a configuration, its dataset's files and a camera, written
from bevy_terrain's rules and importing nothing of the program.

* :mod:`reference.geometry`: surfaces, face coordinates, camera matrices,
  the view's distance rules;
* :mod:`reference.data`: the dataset's tiles and mips, and their samplers;
* :mod:`reference.frame`: the approximate height, the quadtree walk, the
  morphed vertex grids, the shading normals and the lighting;
* :mod:`reference.raster`: a z-buffer rasteriser and per-pixel shading.
"""
