"""Empirical morph-gating analysis of the Earth bench frame.

Twin of tools/morph_gating_analysis.py on the port. For each live tile of
the settled 60 km Earth frame (tools_torch/earth_frame_bench.py's scene,
through the port's ``Terrain``), decide whether ANY vertex can morph
(mr > 0 at some uv): mr = 0 iff lod + morph_range <= log2(2 morph_dist) -
log2(d), with d the largest view distance over the tile's 3x3 uv corner
grid at mid height. Then group the frame's quad-sorted tile list (the
fused kernel's order) into 64-tile kernel steps and count the fully
morph-free steps: the steps a per-step flag could skip the spherical
kernel's second far_geom for (the flag K2 and the TPU kernel take for the
Taylor chains). The counts are host math on the frame's tile list; the
frame itself runs on the card unless ``--cpu``.

Usage: python tools_torch/morph_gating_analysis.py [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TILES_PER_STEP = 64


def analyse(side, lod, xy, count: int, model, view, morph_distance: float,
            morph_range: float, mid_height: float) -> dict:
    """The counts over a quad-sorted tile list (numpy (F,) side, (F,) lod,
    (F, 2) xy; ``count`` live): morphing tiles, live steps, fully
    morph-free live steps and the quartiles of morphing tiles per live
    step. ``model`` gives the sphere (``scale`` is its radius; centred at
    the origin, as the Earth scene's)."""
    from bevy_terrain_tpu_torch.math.coordinate import local_position_from_side_uv

    F = side.shape[0]
    radius = model.scale
    live = np.arange(F) < count
    scale = 1.0 / (2.0 ** lod.astype(np.float64))
    dmax = np.zeros(F)
    for cx in (0.0, 0.5, 1.0):
        for cy in (0.0, 0.5, 1.0):
            suv = np.stack([(xy[:, 0] + cx) * scale, (xy[:, 1] + cy) * scale], axis=-1)
            pos = np.zeros((F, 3))
            for sd in range(6):
                m = side == sd
                if m.any():
                    local = local_position_from_side_uv(sd, suv[m])
                    pos[m] = (radius + mid_height) * local / np.linalg.norm(
                        local, axis=-1, keepdims=True)
            dmax = np.maximum(dmax, np.linalg.norm(pos - np.asarray(view)[None, :], axis=-1))
    target = np.log2(2.0 * morph_distance) - np.log2(np.maximum(dmax, 1e-9))
    morphing = (lod > 0) & (lod + morph_range > target) & live
    steps = F // TILES_PER_STEP
    live_steps = live.reshape(steps, TILES_PER_STEP).any(axis=1)
    morph_steps = morphing.reshape(steps, TILES_PER_STEP).any(axis=1)
    per_step = morphing.reshape(steps, TILES_PER_STEP).sum(axis=1)[live_steps]
    return {"tiles": int(count), "morphing_tiles": int(morphing.sum()),
            "live_steps": int(live_steps.sum()), "steps": steps,
            "morph_free_steps": int((live_steps & ~morph_steps).sum()),
            "morphing_per_step_quartiles": [float(q) for q in np.percentile(
                per_step, [0, 25, 50, 75, 100])] if per_step.size else []}


def report(r: dict) -> None:
    print(f"tiles: {r['tiles']} live; morphing tiles: {r['morphing_tiles']} "
          f"({100 * r['morphing_tiles'] / max(r['tiles'], 1):.1f}% of live)")
    print(f"steps: {r['live_steps']} live of {r['steps']}; fully-morph-free live steps: "
          f"{r['morph_free_steps']} "
          f"({100 * r['morph_free_steps'] / max(r['live_steps'], 1):.1f}%)")
    print("morphing tiles per live step:", r["morphing_per_step_quartiles"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--queue", type=int, default=2048)
    ap.add_argument("--altitude-km", type=float, default=60.0)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math.frustum import view_projection
    from tools_torch.earth_frame_bench import MAX_HEIGHT, RADIUS, earth_terrain, settle

    terrain = earth_terrain(device, args.capacity, args.queue)
    view = np.array([0.0, 0.0, RADIUS + args.altitude_km * 1e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    out = settle(terrain, view, vp)
    F = args.capacity
    t = out.tiles
    model = terrain.config.model
    vc = TerrainViewConfig(tile_capacity=F)
    morph_distance = vc.morph_distance * model.scale
    print("morph_distance (world)", morph_distance, "morph_range", vc.morph_range)
    r = analyse(t.tile_side[:F].cpu().numpy(), t.tile_lod[:F].cpu().numpy(),
                t.tile_xy[:F].cpu().numpy(), out.tile_count, model, view, morph_distance,
                vc.morph_range, 0.5 * MAX_HEIGHT)
    report(r)
    return r


if __name__ == "__main__":
    main()
