"""One frame step of the flagship model, as the repo's entry point takes it.

Torch twin of the repo's ``__graft_entry__.entry``: :func:`entry` returns
a forward frame step on an Earth-scale cube sphere (refinement, then the
per-vertex CDLOD mesh with height sampling) and its example arguments, on
the card unless the caller asks for the CPU::

    fn, args = entry()
    positions, heights, tile_count = fn(*args)

The step takes the per-vertex path (``meshgen.generate_mesh``), as the
JAX entry does, so it launches no hand-written kernel: the kernels run in
``Terrain.update`` (see examples_torch/ and chip_smoke.py).

:func:`dryrun_multichip` is the twin of the JAX file's multi-device dry run
on one card: N distinct views over one streamed atlas
(``parallel.MultiViewTerrain``, its block store in shards and then
replicated), and the spherical multi-view step with distinct cameras
(``parallel.multi_view_frame_step``). The JAX run's audits of the compiled
HLO and its abstract lowering at the production shape have no counterpart:
the port compiles no HLO and steps its views on one device.
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


def sphere_views(n_views: int, device="cuda"):
    """(cfg, [FrameUniforms] * n_views, slab): the entry's sphere at 4 lods,
    grid size 4, capacity 128, seen by ``n_views`` DISTINCT cameras at
    2000 + 500 i m over different points (the JAX dry run's)."""
    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import tile_tree as tile_tree_ops
    from bevy_terrain_tpu_torch.ops.params import make_frame_uniforms

    cfg, _, slab = _build(tile_capacity=128, queue_capacity=512, lod_count=4, grid_size=4,
                          device=device)
    model = TerrainModel.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
    vc = TerrainViewConfig(grid_size=4, tile_capacity=128)
    uniform_list = []
    for i in range(n_views):
        d = np.array([np.cos(i), 0.3 * np.sin(2 * i), np.sin(i)])
        view = model.position_local_to_world(d / np.linalg.norm(d), 2000.0 + 500.0 * i)
        origins, vt_int, vt_frac = tile_tree_ops.compute_view_anchors(
            model, view, cfg.lod_count, vc.tree_size)
        approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 4500.0)
        entries = np.zeros((6, cfg.lod_count, vc.tree_size, vc.tree_size, 2), np.int32)
        uniform_list.append(make_frame_uniforms(model, view, approx, origins, entries, vt_int,
                                                vt_frac, vc, device=device))
    return cfg, uniform_list, slab


def _stream(mvt, positions, frames: int = 30):
    """Stream a MultiViewTerrain until no tile is queued or loading, then
    one more frame."""
    import time

    for _ in range(frames):
        mvt.update(positions)
        if not mvt.atlas.state.to_load and not any(a.loading for a in mvt.atlas.attachments):
            break
        time.sleep(0.01)
    return mvt.update(positions)


def dryrun_multichip(n_views: int, device="cuda") -> dict:
    """Run the multi-view frame step for ``n_views`` DISTINCT views on
    ``device``: each with its own request scan, all sharing ONE streamed
    TileAtlas (a tiny synthetic planar dataset), its block store cut into
    one shard per view, then replicated; then the spherical multi-view
    step with distinct cameras (the Taylor path). Raises when a view meshes
    no tile; prints one ``dryrun_multichip OK:`` line and returns its
    numbers."""
    import tempfile

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain, multi_view_frame_step
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    devices = [torch.device(device)] * n_views
    rng = np.random.default_rng(0)
    positions = {
        f"v{i}": np.array([rng.uniform(-300, 300), rng.uniform(80, 400), rng.uniform(-300, 300)])
        for i in range(n_views)
    }
    view_cfg = TerrainViewConfig(tile_capacity=128, morph_distance=2.0, blend_distance=1.0)
    counts = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_mv_") as root:
        att = AttachmentConfig(name="height", texture_size=128, border_size=2,
                               mip_level_count=2)
        generate_planar_dataset("terrains/dry", 2, att, root=root)
        config = TerrainConfig(
            lod_count=2, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=32, path="terrains/dry", attachments=(att,), assets_root=root,
        )
        for mode, shard_atlas in (("sharded", True), ("replicated", False)):
            mvt = MultiViewTerrain(config, list(positions), devices=devices,
                                   view_config=view_cfg, queue_capacity=512,
                                   shard_atlas=shard_atlas)
            outs = _stream(mvt, positions)
            counts[mode] = [outs[v].tile_count for v in positions]
            if not all(c > 0 for c in counts[mode]):
                raise AssertionError(f"{mode} atlas: a view meshed no tile: {counts[mode]}")

    # the spherical multi-view step with DISTINCT cameras (Taylor path)
    cfg, uniform_list, slab = sphere_views(n_views, device)
    positions_arr, _, tile_counts = multi_view_frame_step(devices, cfg, uniform_list, slab)
    sph_counts = tile_counts.tolist()
    if positions_arr.shape[0] != n_views or not all(c > 0 for c in sph_counts):
        raise AssertionError(f"spherical step: views {positions_arr.shape[0]}, tiles "
                             f"{sph_counts}")
    print(f"dryrun_multichip OK: {n_views} views on {devices[0]}, {n_views} distinct views "
          f"(tiles {counts['sharded']}) on a sharded atlas, (tiles {counts['replicated']}) "
          f"on the replicated one; per-view mesh {tuple(positions_arr.shape[1:])}; "
          f"spherical distinct-views step (tiles {sph_counts})")
    return {"views": n_views, "sharded_tiles": counts["sharded"],
            "replicated_tiles": counts["replicated"], "spherical_tiles": sph_counts,
            "mesh": tuple(positions_arr.shape[1:])}
