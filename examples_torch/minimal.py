"""Minimal terrain: stream a preprocessed planar dataset and fly a camera.

Twin of examples/minimal.py (reference examples/minimal.rs:11-70) on the
port: each frame goes through the planar mesh kernel on the card. Needs a
dataset made by examples_torch/preprocess_planar.py (same constants).

    python examples_torch/preprocess_planar.py && python examples_torch/minimal.py
    (either with --device cpu for the CPU)
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_terrain_tpu_torch import (  # noqa: E402
    AttachmentConfig,
    AttachmentFormat,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
    sample_height,
)

PATH = "terrains/planar"
TERRAIN_SIZE = 1000.0
HEIGHT = 250.0
TEXTURE_SIZE = 512
LOD_COUNT = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = TerrainConfig(
        lod_count=LOD_COUNT,
        model=TerrainModel.planar(np.array([0.0, -100.0, 0.0]), TERRAIN_SIZE, 0.0, HEIGHT),
        atlas_size=1024,
        path=PATH,
        assets_root=args.assets,
    ).add_attachment(
        AttachmentConfig(
            name="height", texture_size=TEXTURE_SIZE, border_size=2,
            mip_level_count=4, format=AttachmentFormat.R16,
        )
    )

    terrain = Terrain(config, device=args.device)
    terrain.add_view("camera", TerrainViewConfig(tile_capacity=4096), queue_capacity=8192)

    # camera flythrough (debug-camera stand-in, reference debug/camera.rs)
    times, tiles = [], []
    for i in range(args.frames):
        t = i / max(args.frames - 1, 1)
        angle = 2 * np.pi * t
        view = np.array(
            [
                0.45 * TERRAIN_SIZE * np.cos(angle),
                -100.0 + 30.0 + 250.0 * (0.3 + 0.2 * np.sin(3 * angle)),
                0.45 * TERRAIN_SIZE * np.sin(angle),
            ]
        )
        t0 = time.perf_counter()
        out = terrain.update({"camera": view})["camera"]
        tiles.append(out.tile_count)  # reads the count: the frame's work is done
        times.append(time.perf_counter() - t0)
        if i % 10 == 0:
            resident = len(terrain.atlas.state.tile_states)
            print(
                f"frame {i:3d}: tiles={out.tile_count:5d} resident={resident:4d} "
                f"wall={times[-1] * 1e3:7.2f} ms"
            )

    h = sample_height(
        terrain.tile_trees["camera"], terrain.atlas, np.array([120.0, 0.0, -80.0])
    )
    print(f"sample_height(120, -80) = {h:.2f} m")
    hs = terrain.query_heights(
        "camera", np.array([[120.0, 0.0, -80.0], [-50.0, 0.0, 200.0]])
    )
    print(f"device query_heights = {hs.cpu().numpy().round(2)} m")
    steady = np.median(times[len(times) // 2 :]) * 1e3
    print(f"steady-state frame: {steady:.2f} ms wall (host+device+stream)")
    return {"tiles": tiles, "sample_height": h, "query_heights": hs.cpu().numpy(),
            "steady_ms": steady}


if __name__ == "__main__":
    main()
