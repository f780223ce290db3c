"""Earth flagship frame benchmark: the tracked spherical number.

Twin of tools/earth_frame_bench.py on the port. Streams a cube-sphere Earth
(radius 6.371e6 m, geometry lods to 13 over 3 data lods, Taylor
high-precision active) at 60 km altitude under a 60-degree frustum camera
through ``Terrain.update`` (the spherical mesh kernel every frame) and
reports the settled frame's device time: the CUDA kernels' own time per
``update`` from ``torch.profiler`` (``utils/timing.device_time_ms``), and
its host wall with a sync (``update_wall_ms``).

Prints one JSON object. --cpu runs on the CPU (correctness only:
``device_ms`` is null there).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


RADIUS = 6_371_000.0
MAX_HEIGHT = 9_000.0
LODS = 13
DATA_LODS = 3


def earth_terrain(device, capacity: int, queue: int):
    """The Earth scene's terrain on ``device``: six 256^2 synthetic faces
    preprocessed into 3 data lods of 512^2 R16 tiles (a 512-slot atlas),
    13 geometry lods, one culled view "cam"."""
    import bevy_terrain_tpu_torch as bt
    from bevy_terrain_tpu_torch.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu_torch.models import height_attachment
    from bevy_terrain_tpu_torch.terrain_data import TileAtlas
    from examples_torch import sources

    def planet(p):
        return np.clip(
            0.5 + 0.3 * np.sin(3 * p[..., 0]) * np.cos(2 * p[..., 2]), 0.05, 1.0
        )

    tmp = Path(tempfile.mkdtemp(prefix="earth_bench_"))
    n = 256
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    faces = {}  # the 16-bit PNGs the JAX tool writes, as they read back
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        path = tmp / f"f{side}.png"
        faces[str(path)] = sources.height_source(planet(p), path)

    config = bt.TerrainConfig(
        lod_count=LODS,
        model=bt.TerrainModel.sphere(np.zeros(3), RADIUS, 0.0, MAX_HEIGHT),
        atlas_size=512,
        path="earth",
        assets_root=str(tmp / "assets"),
        attachments=(height_attachment(texture_size=512, mips=4),),
    )
    atlas = TileAtlas(config, device)
    bt.Preprocessor(atlas, loader=sources.loader(faces)).clear_attachment(
        0).preprocess_spherical(
        bt.SphericalDataset(attachment_index=0, paths=list(faces),
                            lod_range=range(0, DATA_LODS))
    ).run(verbose=False)

    terrain = bt.Terrain(config, device=device)
    terrain.add_view(
        "cam", bt.TerrainViewConfig(tile_capacity=capacity),
        queue_capacity=queue, culling=True,
    )
    return terrain


def settle(terrain, view, view_proj):
    """Stream until no tile is queued or loading (at least 5 frames), then
    one more frame: its output for "cam"."""
    for i in range(200):
        terrain.update({"cam": view}, {"cam": view_proj})
        if i > 3 and not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    return terrain.update({"cam": view}, {"cam": view_proj})["cam"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--altitude-km", type=float, default=60.0)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--headroom", type=float, default=1.3,
                    help="adaptive-ladder headroom over the last tile count "
                         "(static camera: tight is safe; flythroughs want 2.0)")
    ap.add_argument("--queue", type=int, default=2048,
                    help="refinement spill-queue capacity (deep lods beyond "
                         "the dense cascade); sized for the 60 km frame")
    ap.add_argument("--capacity", type=int, default=2048,
                    help="flat tile capacity. 2048 covers the 1512-tile "
                         "60 km frame with 1.35x headroom — the same "
                         "next-pow2 sizing rule as the planar headline "
                         "(4096 for 2582 tiles); overflow is asserted 0")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    # (the JAX tool's jax_compilation_cache_dir has no counterpart here)

    from bevy_terrain_tpu_torch.math.frustum import view_projection
    from bevy_terrain_tpu_torch.utils.timing import benchmark, device_time_ms

    terrain = earth_terrain(device, args.capacity, args.queue)
    if args.adaptive:
        terrain.enable_adaptive_capacity(
            "cam", ladder=[1024, 2048, 4096], headroom=args.headroom
        )

    view = np.array([0.0, 0.0, RADIUS + args.altitude_km * 1e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    out = settle(terrain, view, vp)
    tiles = out.tile_count
    overflow = out.overflow

    def frame():
        return terrain.update({"cam": view}, {"cam": vp})

    ms = device_time_ms(frame, label="earth") if not args.cpu else None
    wall = benchmark(frame, n=5, warmup=1)
    stats = {
        "benchmark": "earth_frame",
        "backend": torch.cuda.get_device_name(0) if not args.cpu else "cpu",
        "altitude_km": args.altitude_km,
        "lod_count": LODS,
        "tiles": tiles,
        "capacity": args.capacity,
        "overflow": overflow,
        "device_ms": None if ms is None else round(ms, 4),
        "update_wall_ms": round(wall["median_ms"], 3),
    }
    if args.adaptive:
        stats["adaptive_capacity"] = terrain._adaptive["cam"]["capacity"]
    json.dump(stats, sys.stdout)
    print()
    assert overflow == 0 or args.adaptive
    assert tiles > 100
    return stats


if __name__ == "__main__":
    main()
