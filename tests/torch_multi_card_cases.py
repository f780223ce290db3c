"""The ranks' side of tests/test_torch_multi_card.py: what each process of
a four-rank group runs (``parallel.launch.launch(cases, 4, root,
structure_root, device="cpu")``), and the scene both sides build.

Spawned ranks import this module, so it imports neither jax nor the JAX
package (tests/test_torch_jax_free.py checks it). The scene is
tests/test_multi_view.py's: a 3-lod synthetic planar dataset (512^2 R16
tiles, 1000 m, a 64-slot atlas), the view config capacity 512,
``morph_distance=2.0``, ``blend_distance=1.0``, queue 1024, and the first 4
of its 8 seeded views.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

N_VIEWS = 4
# tests/test_torch_multi_view.py::test_fetch_patches_sharded_is_the_plain_gather's
# store: 37 blocks (divides by 1 only), ids over every block
FETCH_BLOCKS, FETCH_IDS = 37, 50


def positions() -> dict:
    """The first N_VIEWS of tests/test_multi_view.py's seeded views."""
    rng = np.random.default_rng(5)
    views = {f"v{i}": np.array([rng.uniform(-300, 300), rng.uniform(80, 400),
                                rng.uniform(-300, 300)]) for i in range(8)}
    return dict(list(views.items())[:N_VIEWS])


def view_config():
    from bevy_terrain_tpu_torch.config import TerrainViewConfig

    return TerrainViewConfig(tile_capacity=512, morph_distance=2.0, blend_distance=1.0)


def config(root: str):
    from bevy_terrain_tpu_torch.config import AttachmentConfig, AttachmentFormat, TerrainConfig
    from bevy_terrain_tpu_torch.math import TerrainModel

    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4,
                           format=AttachmentFormat.R16)
    return TerrainConfig(
        lod_count=3, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=64, path="terrains/mv", attachments=(att,), assets_root=str(root))


def stream(mvt, pos, frames: int = 40):
    """Update until no tile is queued or loading, then once more (the
    stream of tests/test_multi_view.py; in a group every rank makes the same
    calls). Returns the last frame and the number of frames."""
    for i in range(frames):
        mvt.update(pos)
        if not mvt.streaming():
            break
    return mvt.update(pos), i + 2


def frame_arrays(frame) -> dict:
    """A view's tiles and mesh as numpy arrays, field by field."""
    return {f"{part}.{f.name}": getattr(obj, f.name).cpu().numpy()
            for part, obj in (("tiles", frame.tiles), ("mesh", frame.mesh))
            for f in dataclasses.fields(obj)}


def fetch_inputs():
    """(blocks (37, 32, 128) int32, ids (50, 4) int32): random words,
    positive and negative, every block requested."""
    rng = np.random.default_rng(4)
    blocks = rng.integers(-2 ** 31, 2 ** 31 - 1, (FETCH_BLOCKS, 32, 128),
                          dtype=np.int64).astype(np.int32)
    blocks[:8] = rng.integers(0, 65535, (8, 32, 128))
    ids = rng.integers(0, FETCH_BLOCKS, (FETCH_IDS, 4)).astype(np.int32)
    ids[:FETCH_BLOCKS, 0] = np.arange(FETCH_BLOCKS)
    return blocks, ids


# the atlas modes: (shard_atlas, static overrides); "fused" is the
# replicated store through the fused mesh kernel (its plain version here)
MODES = {"replicated": (False, {}), "sharded": (True, {}),
         "fused": (False, {"pallas_sampling": True})}


def _mode(root, group, device, mode: str) -> dict:
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain
    from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasAttachment
    from bevy_terrain_tpu_torch.utils.loading import loads_in_step

    pos = positions()
    shard_atlas, overrides = MODES[mode]
    mvt = MultiViewTerrain(config(root), list(pos), devices=[device] * N_VIEWS,
                           view_config=view_config(), queue_capacity=1024,
                           shard_atlas=shard_atlas, group=group, **overrides)
    with loads_in_step(AtlasAttachment):
        outs, frames = stream(mvt, pos)
    v = mvt.view_ids[mvt.rank]
    out = {"view": v, "frames": frames, "frame": frame_arrays(outs[v]),
           "pallas_sampling": mvt.cfg.pallas_sampling, "audit": mvt.audit_step(),
           "host_stats": mvt.host_stats, "store": tuple(mvt.terrain.store.shape),
           "first_block": mvt.terrain.first_block, "n_blocks": int(
               mvt.atlas.attachments[0].block_array.shape[0])}
    gathered = mvt.gather_frames(outs)
    if mvt.rank == 0:
        out["gathered"] = {w: frame_arrays(f) for w, f in gathered.items()}
        out["requested"] = sum(int(t.tile_requested.sum()) for t in mvt.tile_trees.values())
        out["resident"] = len(mvt.atlas.state.tile_states)
    return out


def cases(rank: int, group, device, root: str, structure_root: str) -> dict:
    """Every case on this rank: the MultiViewTerrain in each of MODES,
    the group ``fetch_patches_sharded``, the group ``multi_view_frame_step``
    on ``entry.sphere_views``, the group ``dryrun_multichip`` and the rank's
    part of tools_torch/multi_view_bench.py's structure check (its dataset
    under ``structure_root``)."""
    import torch.distributed as dist

    from bevy_terrain_tpu_torch.entry import dryrun_multichip, sphere_views
    from bevy_terrain_tpu_torch.parallel import fetch_patches_sharded, multi_view_frame_step
    from bevy_terrain_tpu_torch.parallel.collective_audit import profile_collectives
    from bevy_terrain_tpu_torch.parallel.sharded_atlas import shard_range
    from tools_torch.multi_view_bench import structure_rank

    out = {m: _mode(root, group, device, m) for m in MODES}

    blocks, ids = fetch_inputs()
    first, per = shard_range(FETCH_BLOCKS, dist.get_world_size(group), rank)
    shard = torch.zeros((per, 32, 128), dtype=torch.int32)
    mine = blocks[first:first + per]
    shard[:len(mine)] = torch.from_numpy(mine)
    patches, stats, _ = profile_collectives(fetch_patches_sharded, shard, torch.from_numpy(ids),
                                            group, device=device)
    out["fetch"] = {"patches": patches.numpy(), "audit": stats}

    cfg, uniforms, slab = sphere_views(N_VIEWS, device=device)
    step, stats = multi_view_frame_step([device] * N_VIEWS, cfg, uniforms, slab, audit=True,
                                        group=group)
    out["sphere"] = {"step": [x.numpy() for x in step], "audit": stats}
    out["dryrun"] = dryrun_multichip(N_VIEWS, device=device, group=group)
    out["structure"] = structure_rank(rank, group, device, structure_root)
    return out


def fail_on_rank_one(rank: int, group, device) -> int:
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank
