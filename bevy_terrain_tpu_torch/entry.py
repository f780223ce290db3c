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

:func:`dryrun_multichip` is the twin of the JAX file's multi-device dry run:
N distinct views over one streamed atlas (``parallel.MultiViewTerrain``,
its block store in shards and then replicated), and the spherical
multi-view step with distinct cameras (``parallel.multi_view_frame_step``),
on one device, or one view per rank of a process group
(parallel/launch.py). On a group it also makes the JAX run's collective
audits, read from profiler traces (parallel/collective_audit.py), and on
the cards runs the sharded step at the production shape for real where
the JAX run lowers it abstractly.
"""

from __future__ import annotations

import dataclasses

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
        if not mvt.streaming():
            break
        time.sleep(0.01)
    return mvt.update(positions)


def _tile_counts(mvt, outs) -> list:
    """Every view's tile count (in a group, gathered from the ranks)."""
    import torch.distributed as dist

    if mvt.group is None:
        return [outs[v].tile_count for v in mvt.view_ids]
    mine = torch.tensor([outs[mvt.view_ids[mvt.rank]].tile_count], device=mvt.device)
    every = mine.new_empty(len(mvt.view_ids))
    dist.all_gather_into_tensor(every, mine, group=mvt.group)
    return every.tolist()


# the production shape of the sharded step: the 8k^2 planar headline's
# capacity 4096 over a 1024-slot atlas of 512^2 R16 tiles with 4 mips
# (86 016 blocks), the JAX dry run's abstract lowering
PRODUCTION = dict(tile_capacity=4096, atlas_size=1024, texture_size=512, mip_level_count=4)


def dryrun_multichip(n_views: int, device="cuda", group=None) -> dict:
    """Run the multi-view frame step for ``n_views`` DISTINCT views: each
    with its own request scan, all sharing ONE streamed TileAtlas (a tiny
    synthetic planar dataset), its block store cut into one shard per view,
    then replicated; then the spherical multi-view step with distinct
    cameras (the Taylor path). Raises when a view meshes no tile.

    Without ``group`` every view steps on ``device``; prints one
    ``dryrun_multichip OK:`` line. With a process group of ``n_views``
    ranks (``device`` is this rank's), one view per rank, and the JAX dry
    run's asserts on the audited collectives: the sharded step shows them,
    the replicated step and the spherical step show none; on the cards the
    sharded step also runs at :data:`PRODUCTION`'s shape. Rank 0 prints
    the JAX run's lines. Returns the numbers."""
    import tempfile

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain, multi_view_frame_step
    from bevy_terrain_tpu_torch.parallel.collective_audit import format_stats
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    device = torch.device(device)
    if group is not None and device.type == "cuda":
        devices = [torch.device("cuda", r) for r in range(n_views)]
    else:
        devices = [device] * n_views
    rng = np.random.default_rng(0)
    positions = {
        f"v{i}": np.array([rng.uniform(-300, 300), rng.uniform(80, 400), rng.uniform(-300, 300)])
        for i in range(n_views)
    }
    view_cfg = TerrainViewConfig(tile_capacity=128, morph_distance=2.0, blend_distance=1.0)
    counts, stats = {}, {}
    # in a group only rank 0 runs the host flow, so only it reads tiles
    host = group is None or torch.distributed.get_rank(group) == 0
    with tempfile.TemporaryDirectory(prefix="dryrun_mv_") as root:
        att = AttachmentConfig(name="height", texture_size=128, border_size=2,
                               mip_level_count=2)
        if host:
            generate_planar_dataset("terrains/dry", 2, att, root=root)
        config = TerrainConfig(
            lod_count=2, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
            atlas_size=32, path="terrains/dry", attachments=(att,), assets_root=root,
        )
        for mode, shard_atlas in (("sharded", True), ("replicated", False)):
            mvt = MultiViewTerrain(config, list(positions), devices=devices,
                                   view_config=view_cfg, queue_capacity=512,
                                   shard_atlas=shard_atlas, group=group)
            counts[mode] = _tile_counts(mvt, _stream(mvt, positions))
            if not all(c > 0 for c in counts[mode]):
                raise AssertionError(f"{mode} atlas: a view meshed no tile: {counts[mode]}")
            if group is not None:
                stats[mode] = mvt.audit_step()
        if group is not None and device.type == "cuda":
            patt = AttachmentConfig(name="height", texture_size=PRODUCTION["texture_size"],
                                    border_size=2, mip_level_count=PRODUCTION["mip_level_count"])
            if host:
                generate_planar_dataset("terrains/prod", 3, patt, root=root)
            pconfig = dataclasses.replace(config, lod_count=3, path="terrains/prod",
                                          atlas_size=PRODUCTION["atlas_size"],
                                          attachments=(patt,))
            mvt = MultiViewTerrain(pconfig, list(positions), devices=devices,
                                   view_config=TerrainViewConfig(
                                       tile_capacity=PRODUCTION["tile_capacity"],
                                       morph_distance=2.0, blend_distance=1.0),
                                   queue_capacity=8192, shard_atlas=True, group=group)
            counts["production"] = _tile_counts(mvt, _stream(mvt, positions))
            stats["production"] = mvt.audit_step()
            stats["production_blocks"] = int(mvt.atlas.attachments[0].block_array.shape[0])
            del mvt
    if group is not None:
        if not stats["sharded"]:
            raise AssertionError("sharded-atlas step must show its collectives")
        if stats["replicated"]:
            raise AssertionError("replicated-atlas step must be collective-free, found: "
                                 f"{format_stats(stats['replicated'])}")

    # the spherical multi-view step with DISTINCT cameras (Taylor path)
    rank_device = devices[0] if group is None else devices[torch.distributed.get_rank(group)]
    cfg, uniform_list, slab = sphere_views(n_views, rank_device)
    (positions_arr, _, tile_counts), sph_stats = multi_view_frame_step(
        devices, cfg, uniform_list, slab, audit=True, group=group)
    sph_counts = tile_counts.tolist()
    per_rank = n_views if group is None else 1
    if positions_arr.shape[0] != per_rank or not all(c > 0 for c in sph_counts):
        raise AssertionError(f"spherical step: views {positions_arr.shape[0]}, tiles "
                             f"{sph_counts}")
    if sph_stats:
        raise AssertionError("replicated spherical step must be collective-free: "
                             f"{format_stats(sph_stats)}")
    result = {"views": n_views, "sharded_tiles": counts["sharded"],
              "replicated_tiles": counts["replicated"], "spherical_tiles": sph_counts,
              "mesh": tuple(positions_arr.shape[1:])}
    if group is None:
        print(f"dryrun_multichip OK: {n_views} views on {devices[0]}, {n_views} distinct views "
              f"(tiles {counts['sharded']}) on a sharded atlas, (tiles "
              f"{counts['replicated']}) on the replicated one; per-view mesh "
              f"{tuple(positions_arr.shape[1:])}; spherical distinct-views step (tiles "
              f"{sph_counts})")
        return result
    result.update(audits=stats, spherical_audit=sph_stats)
    prod = (format_stats(stats["production"], n_views) if "production" in stats
            else "not run (the CPU: the production store is run on the cards only)")
    if torch.distributed.get_rank(group) == 0:
        print(f"dryrun_multichip OK: {n_views} devices, {n_views} distinct views (tiles "
              f"{counts['sharded']}) on a sharded atlas; per-view mesh "
              f"{tuple(positions_arr.shape[1:])}\n"
              f"  replicated-atlas step: no collectives (asserted; mesh-size-independent)\n"
              f"  spherical hp distinct-views step: no collectives (asserted)\n"
              f"  sharded-atlas step (tiny): {format_stats(stats['sharded'], n_views)}\n"
              f"  sharded-atlas step (production 8k^2 shape, capacity 4096, 1024-slot 512^2 "
              f"atlas): {prod}")
    return result
