"""One frame step of the flagship model, as the repo's entry point takes it.

Torch twin of the repo's ``__graft_entry__.entry``: :func:`entry` returns
a forward frame step on an Earth-scale cube sphere (refinement, then the
per-vertex CDLOD mesh with height sampling) and its example arguments, on
the card unless the caller asks for the CPU::

    fn, args = entry()
    positions, heights, tile_count = fn(*args)

The step takes the per-vertex path (``meshgen.generate_mesh``), as the
JAX entry does, so it launches no hand-written kernel: the kernels run in
``Terrain.update`` (see examples_torch/ and chip_smoke.py). The JAX file's
``dryrun_multichip`` belongs to the multi-view port (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch


def _build(tile_capacity=512, queue_capacity=2048, lod_count=6, grid_size=8,
           spherical=True, device="cuda"):
    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import tile_tree as tile_tree_ops
    from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, make_frame_uniforms

    if spherical:
        model = TerrainModel.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
        view = model.position_local_to_world(np.array([0.0, 0.0, 1.0]), 2000.0)
    else:
        model = TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 250.0)
        view = np.array([50.0, 100.0, -50.0])

    vc = TerrainViewConfig(grid_size=grid_size, tile_capacity=tile_capacity)
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical,
        side_count=model.side_count,
        lod_count=lod_count,
        tree_size=vc.tree_size,
        grid_size=vc.grid_size,
        refinement_count=16,
        queue_capacity=queue_capacity,
        tile_capacity=tile_capacity,
        origin_lod=vc.origin_lod,
        high_precision=spherical,
    )
    origins, vt_int, vt_frac = tile_tree_ops.compute_view_anchors(
        model, view, lod_count, vc.tree_size
    )
    approx = TerrainModelApproximation.compute(
        model, view, vc.origin_lod, (model.min_height + model.max_height) / 2
    )
    entries = np.zeros(
        (model.side_count, lod_count, vc.tree_size, vc.tree_size, 2), np.int32
    )
    uniforms = make_frame_uniforms(
        model, view, approx, origins, entries, vt_int, vt_frac, vc, device=device
    )
    slab = torch.zeros((64, 128, 128, 1), dtype=torch.uint16, device=device)
    return cfg, uniforms, slab


def entry(device="cuda"):
    """(fn, example_args): the forward frame step on ``device``."""
    from bevy_terrain_tpu_torch.ops import meshgen, refinement

    cfg, uniforms, slab = _build(device=device)

    def step(height_slab, uniforms):
        tiles = refinement.refine_tiles(uniforms, cfg)
        mesh = meshgen.generate_mesh(
            tiles, height_slab, uniforms, cfg, 124 / 128, 2 / 128
        )
        return mesh.positions, mesh.heights, tiles.tile_count

    return step, (slab, uniforms)
