"""Cube-sphere planet: preprocess six faces and orbit a camera.

Twin of examples/spherical.py (reference examples/spherical.rs +
preprocess_spherical.rs) on the port: each frame goes through the
spherical mesh kernel on the card. With no dataset it makes six 1024^2
faces of an analytic planet in memory first (and writes them as PNGs where
PIL imports).

    python examples_torch/spherical.py [--assets DIR] [--frames N] [--device cpu]
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
    Preprocessor,
    SphericalDataset,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
)
from bevy_terrain_tpu_torch.debug import ApproachCamera  # noqa: E402
from bevy_terrain_tpu_torch.math.coordinate import local_position_from_side_uv  # noqa: E402
from bevy_terrain_tpu_torch.math.frustum import view_projection  # noqa: E402
from bevy_terrain_tpu_torch.terrain_data import TileAtlas  # noqa: E402
from examples_torch import sources  # noqa: E402

PATH = "terrains/spherical"
RADIUS = 6.371e6
MIN_HEIGHT, MAX_HEIGHT = 0.0, 9000.0
LOD_COUNT = 4
TEXTURE_SIZE = 512


def planet_height(p):
    """Analytic normalized planet heights from a unit-sphere position."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    h = (
        0.45
        + 0.25 * np.sin(3 * x + 1) * np.cos(4 * y)
        + 0.18 * np.sin(5 * z + 2) * np.sin(2 * x * y + 0.5)
        + 0.08 * np.cos(11 * (x + y + z))
    )
    return np.clip(h, 0.02, 1.0)


def synthesize_faces(out_dir: Path, n: int = 1024):
    """(paths, loader): the six faces' source paths and a ``Preprocessor``
    loader over them, made in memory."""
    paths, faces = [], {}
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        path = out_dir / f"face{side}.png"
        faces[str(path)] = sources.height_source(planet_height(p), path)
        paths.append(str(path))
    return paths, sources.loader(faces)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument(
        "--ellipsoid", action="store_true",
        help="WGS84-like ellipsoid (reference examples/spherical.rs:6-11) "
        "instead of a sphere; the approach descends to 3 km so deep "
        "geometry lods + the Taylor relative path are exercised",
    )
    ap.add_argument("--lods", type=int, default=None,
                    help="lod_count override (ellipsoid default 16)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.ellipsoid:
        model = TerrainModel.ellipsoid(
            np.zeros(3), 6_378_137.0, 6_356_752.3, MIN_HEIGHT, MAX_HEIGHT
        )
        lod_count = args.lods or 16
    else:
        model = TerrainModel.sphere(np.zeros(3), RADIUS, MIN_HEIGHT, MAX_HEIGHT)
        lod_count = args.lods or LOD_COUNT
    config = TerrainConfig(
        lod_count=lod_count,
        model=model,
        atlas_size=2048,
        path=PATH + ("_ellipsoid" if args.ellipsoid else ""),
        assets_root=args.assets,
    ).add_attachment(
        AttachmentConfig(
            name="height", texture_size=TEXTURE_SIZE, border_size=2,
            mip_level_count=4, format=AttachmentFormat.R16,
        )
    )

    manifest = Path(args.assets) / config.path / "config.tc"
    if not manifest.exists():
        atlas = TileAtlas(config, args.device)
        src_dir = Path(args.assets) / "source"
        src_dir.mkdir(parents=True, exist_ok=True)
        print("synthesizing six cube faces...")
        paths, loader = synthesize_faces(src_dir)
        Preprocessor(atlas, loader=loader).clear_attachment(0).preprocess_spherical(
            SphericalDataset(
                attachment_index=0, paths=paths,
                lod_range=range(0, min(lod_count, LOD_COUNT)),
            )
        ).run()

    terrain = Terrain(config, device=args.device)
    terrain.add_view("camera", TerrainViewConfig(tile_capacity=8192),
                     queue_capacity=32768, culling=True)
    terrain.set_shading(lighting=True)

    cam = ApproachCamera(
        target=np.zeros(3), start_distance=3.0 * RADIUS,
        end_distance=RADIUS + (3_000.0 if args.ellipsoid else 20_000.0),
    )
    times, tiles = [], []
    for i, view in enumerate(cam.path(args.frames)):
        # 60-degree frustum looking at the planet: out-of-view subtrees
        # are culled inside refinement (the reference declares but never
        # populates its culling planes)
        vp = view_projection(view, np.zeros(3), np.pi / 3, 16 / 9)
        t0 = time.perf_counter()
        out = terrain.update({"camera": view}, {"camera": vp})["camera"]
        tiles.append(out.tile_count)  # reads the count: the frame's work is done
        times.append(time.perf_counter() - t0)
        if i % 10 == 0:
            print(
                f"frame {i:3d}: dist={np.linalg.norm(view) - RADIUS:12.0f} m "
                f"tiles={out.tile_count:5d} resident={len(terrain.atlas.state.tile_states):4d} "
                f"wall={times[-1] * 1e3:8.2f} ms"
            )
    steady = np.median(times[len(times) // 2 :]) * 1e3
    print(f"steady-state frame: {steady:.2f} ms wall")

    # batched device-side surface queries under the final camera
    d = view / np.linalg.norm(view)
    pts = np.outer(np.linspace(0.999, 1.001, 8), d * RADIUS)
    hs = terrain.query_heights("camera", pts).cpu().numpy()
    print(f"query_heights along the boresight: {hs.round(1)}")
    return {"tiles": tiles, "query_heights": hs, "steady_ms": steady}


if __name__ == "__main__":
    main()
