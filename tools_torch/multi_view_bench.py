"""Multi-view measurement on the bench.py 8k^2 planar scene.

Twin of tools/multi_view_bench.py on the port. Three measurements:

1. one view's fused frame (refinement, patch plan and the planar mesh
   kernel K1): device time per call (``utils/timing.device_time_ms``);
2. TWO distinct views sharing one block store, each with its own fused
   frame, in one call: device time, and per view against (1) (each view
   adds its own launches and nothing else);
3. ``MultiViewTerrain`` on the card, streamed over a synthetic dataset: it
   must select the fused mesh kernel (``cfg.pallas_sampling``).

With ``--cpu`` the three run on the CPU (the kernel's plain version), their
rows host wall, named so; then the JAX tool's ``--cpu`` structure check:
the multi-view step of a 4-rank gloo group (parallel/launch.py, one view
per rank, the JAX check's scene and first 4 of its views), one frame per
atlas mode, its collectives read from a profiler trace
(``MultiViewTerrain.audit_step``) where the JAX tool scans the compiled
HLO: the sharded-atlas step must show its fetch, the replicated one none.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


STRUCTURE_RANKS = 4


def structure_config(root: str):
    """The JAX tool's ``--cpu`` scene: a 3-lod 512^2 planar dataset under
    ``root``, 8000 m, a 128-slot atlas."""
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig
    from bevy_terrain_tpu_torch.math import TerrainModel

    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4)
    return TerrainConfig(
        lod_count=3, model=TerrainModel.planar(np.zeros(3), 8000.0, 0.0, 250.0),
        atlas_size=128, path="terrains/mvs", attachments=(att,), assets_root=root)


def structure_rank(rank, group, device, root: str) -> dict:
    """One rank of the structure check: per atlas mode, one frame of the
    group ``MultiViewTerrain``, then the audit of its step."""
    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain

    rng = np.random.default_rng(3)
    positions = {f"v{i}": np.array([rng.uniform(-300, 300), rng.uniform(80, 400),
                                    rng.uniform(-300, 300)]) for i in range(8)}
    positions = dict(list(positions.items())[:STRUCTURE_RANKS])
    found = {}
    for shard_atlas in (False, True):
        mvt = MultiViewTerrain(
            structure_config(root), list(positions), devices=[device] * STRUCTURE_RANKS,
            view_config=TerrainViewConfig(tile_capacity=512, morph_distance=2.0,
                                          blend_distance=1.0),
            queue_capacity=1024, shard_atlas=shard_atlas, group=group)
        mvt.update(positions)
        found["sharded-atlas" if shard_atlas else "replicated-atlas"] = mvt.audit_step()
    return found


def structure_check() -> dict:
    """The JAX tool's ``--cpu`` check on a 4-rank gloo group: {atlas mode:
    the step's collectives} of rank 0, every rank's the same."""
    from bevy_terrain_tpu_torch.parallel import launch
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    with tempfile.TemporaryDirectory(prefix="mv_struct_") as root:
        generate_planar_dataset("terrains/mvs", 3, structure_config(root).attachments[0],
                                root=root)
        ranks = [r["result"] for r in launch(structure_rank, STRUCTURE_RANKS, root,
                                             device="cpu")]
    return report_structure(ranks)


def report_structure(ranks: list) -> dict:
    """Hold the ranks' ``structure_rank`` results to the JAX tool's check
    and print its lines; returns rank 0's."""
    from bevy_terrain_tpu_torch.parallel.collective_audit import format_stats

    if any(r != ranks[0] for r in ranks):
        raise AssertionError(f"the ranks audit different steps: {ranks}")
    found = ranks[0]
    if not found["sharded-atlas"]:
        raise AssertionError("sharded-atlas step lost its collective fetch")
    print(f"sharded-atlas: collectives {sorted(found['sharded-atlas'])} (expected: the "
          f"all-gather + reduce-scatter fetch): "
          f"{format_stats(found['sharded-atlas'], STRUCTURE_RANKS)}")
    if found["replicated-atlas"]:
        raise AssertionError("replicated-atlas step has collectives: "
                             f"{format_stats(found['replicated-atlas'])}")
    print("replicated-atlas: NO cross-device collectives -> per-device cost is "
          "mesh-size-independent (each rank runs the single-view program)")
    return found


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel
    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from bevy_terrain_tpu_torch.parallel import MultiViewTerrain
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
    from tools_torch.scenes import build_scene, time_ms

    cfg, plan, blocks, u1, u2 = build_scene(device=device)
    on_card = not args.cpu

    def one_view(block_array, u):
        tiles = refinement.refine_tiles(u, cfg)
        raw, tiles = meshgen.generate_mesh_fused(tiles, block_array, u, cfg, plan, 65535.0)
        return tiles.tile_count, raw

    def two_views(block_array, ua, ub):
        return one_view(block_array, ua), one_view(block_array, ub)

    c1 = int(one_view(blocks, u1)[0])
    (ca, _), (cb, _) = two_views(blocks, u1, u2)
    t1, what = time_ms(one_view, blocks, u1, label="mv_single", on_card=on_card)
    t2, _ = time_ms(two_views, blocks, u1, u2, label="mv_double", on_card=on_card)
    ratio = t2 / 2 / t1
    print(f"single view: {t1 * 1e3:.1f} us {what} ({c1} tiles)\n"
          f"two views, one card, shared atlas: {t2 * 1e3:.1f} us total, "
          f"{t2 / 2 * 1e3:.1f} us/view ({int(ca)}+{int(cb)} tiles) "
          f"-> per-view ratio {ratio:.3f}x")

    # MultiViewTerrain streamed on the card: the fused mesh kernel per view
    with tempfile.TemporaryDirectory(prefix="mv_bench_") as root:
        att = AttachmentConfig(name="height", texture_size=512, border_size=2,
                               mip_level_count=4)
        generate_planar_dataset("terrains/mv", 3, att, root=root)
        config = TerrainConfig(
            lod_count=3, model=TerrainModel.planar(np.zeros(3), 8000.0, 0.0, 250.0),
            atlas_size=128, path="terrains/mv", attachments=(att,), assets_root=root,
        )
        mvt = MultiViewTerrain(config, ["cam"], devices=[device],
                               view_config=TerrainViewConfig(tile_capacity=1024),
                               queue_capacity=1024)
        if mvt.cfg.pallas_sampling != on_card:
            raise AssertionError("MultiViewTerrain did not select the fused mesh kernel on "
                                 "the card (or selected it on the CPU)")
        positions = {"cam": np.array([240.0, 180.0, -160.0])}
        for _ in range(40):
            mvt.update(positions)
            if not mvt.atlas.state.to_load and not any(
                    a.loading for a in mvt.atlas.attachments):
                break
            time.sleep(0.01)
        mv_tiles = mvt.update(positions)["cam"].tile_count
    path = "fused mesh kernel" if on_card else "staged grid path"
    print(f"MultiViewTerrain ({path}): ok, {mv_tiles} tiles")
    result = {"timing": what, "single_us": t1 * 1e3, "single_tiles": c1,
              "double_us": t2 * 1e3, "double_tiles": [int(ca), int(cb)],
              "per_view_ratio": ratio, "multi_view_tiles": mv_tiles,
              "multi_view_fused": on_card}
    if args.cpu:
        result["structure"] = structure_check()
    return result


if __name__ == "__main__":
    main()
