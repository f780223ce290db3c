"""Planar terrain with an albedo attachment and a custom material.

Twin of examples/planar.py (reference examples/planar.rs: a custom
material sampling a color attachment, debug views) on the port.
Self-contained: makes height + albedo sources in memory and preprocesses
both attachments on the first run. The albedo (border 1) has another patch
plan than the height (border 2), so its material is staged: the planar
mesh kernel, the staged sampler, then the shade.

    python examples_torch/planar.py [--assets DIR] [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_terrain_tpu_torch import (  # noqa: E402
    PreprocessDataset,
    Preprocessor,
    StandardMaterial,
    Terrain,
    TerrainConfig,
    TerrainModel,
    TerrainViewConfig,
    albedo_material,
    gradient_material,
)
from bevy_terrain_tpu_torch.models import albedo_attachment, height_attachment  # noqa: E402
from bevy_terrain_tpu_torch.terrain_data import TileAtlas  # noqa: E402
from examples_torch import sources  # noqa: E402

PATH = "terrains/planar_albedo"
SIZE = 1000.0
HEIGHT = 250.0
LOD_COUNT = 3


def height_field(u, v):
    return np.clip(
        0.5 + 0.3 * np.sin(2 * np.pi * 2 * u) * np.cos(2 * np.pi * 3 * v), 0.02, 1.0
    )


def albedo_field(u, v):
    """RGB from a simple biome colormap over the height field."""
    h = height_field(u, v)
    r = np.clip(1.8 * h - 0.4, 0.05, 1.0)
    g = np.clip(1.2 - 1.5 * np.abs(h - 0.45), 0.05, 1.0)
    b = np.clip(0.9 - h, 0.05, 1.0)
    a = np.ones_like(h)
    return np.stack([r, g, b, a], axis=-1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = TerrainConfig(
        lod_count=LOD_COUNT,
        model=TerrainModel.planar(np.zeros(3), SIZE, 0.0, HEIGHT),
        atlas_size=256,
        path=PATH,
        assets_root=args.assets,
        attachments=(height_attachment(), albedo_attachment()),
    )

    manifest = Path(args.assets) / PATH / "config.tc"
    if not manifest.exists():
        atlas = TileAtlas(config, args.device)
        n = 1024
        uv = (np.arange(n) + 0.5) / n
        uu, vv = np.meshgrid(uv, uv, indexing="xy")
        src_dir = Path(args.assets) / "source"
        src_dir.mkdir(parents=True, exist_ok=True)
        height_png, albedo_png = src_dir / "pa_height.png", src_dir / "pa_albedo.png"
        loader = sources.loader({
            str(height_png): sources.height_source(height_field(uu, vv), height_png),
            str(albedo_png): sources.rgba8_source(albedo_field(uu, vv), albedo_png),
        })

        pre = Preprocessor(atlas, loader=loader).clear_attachment(0)
        pre.preprocess_tile(
            PreprocessDataset(attachment_index=0, path=str(height_png),
                              lod_range=range(0, LOD_COUNT))
        )
        pre.preprocess_tile(
            PreprocessDataset(attachment_index=1, path=str(albedo_png),
                              lod_range=range(0, LOD_COUNT))
        )
        pre.run()

    terrain = Terrain(config, device=args.device)
    terrain.add_view("camera", TerrainViewConfig(tile_capacity=2048), queue_capacity=4096)

    # the reference example's custom TerrainMaterial (examples/planar.rs +
    # assets/shaders/planar.wgsl): ALBEDO branch = color straight from the
    # albedo attachment, sampled at the frame's vertices, lit by the PBR
    # stage
    terrain.set_shading(
        material=StandardMaterial(base_color=albedo_material(1)),
        lighting=True,
        sample_attachments=(1,),
    )
    view = np.array([120.0, 200.0, -150.0])
    out = None
    for _ in range(40):
        out = terrain.update({"camera": view})["camera"]
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.02)
    out = terrain.update({"camera": view})["camera"]

    mask = _host(out.mesh.tile_mask)
    lit = _host(out.colors)[mask]
    print(f"tiles={out.tile_count} lit RGBA shape={tuple(out.colors.shape)}")
    print(f"lit mean RGB = {lit[..., :3].reshape(-1, 3).mean(axis=0)}")

    # the non-ALBEDO branch: gradient LUT at pow(height, 0.9)
    terrain.set_shading(material=gradient_material(), lighting=True)
    out_g = terrain.update({"camera": view})["camera"]
    g = _host(out_g.colors)[_host(out_g.mesh.tile_mask)]
    print(f"gradient-material mean RGB = {g[..., :3].reshape(-1, 3).mean(axis=0)}")

    albedo = terrain.sample_attachment_grid("camera", out, attachment_index=1)
    a = _host(albedo)[mask]
    print(f"albedo grid shape={tuple(albedo.shape)}")
    print(f"albedo mean RGB = {a[..., :3].reshape(-1, 3).mean(axis=0)}")

    # sanity: compare a vertex's sampled albedo against the analytic colormap
    pos = _host(out.mesh.positions)[mask]
    u = pos[..., 0] / SIZE + 0.5
    v = pos[..., 2] / SIZE + 0.5
    expect = albedo_field(u, v)
    err = np.abs(a[..., :3] - expect[..., :3])
    print(f"albedo vs analytic: median err {np.median(err):.4f} (0..1 scale)")
    return {"tiles": out.tile_count, "lit_mean": lit[..., :3].reshape(-1, 3).mean(axis=0),
            "albedo_median_err": float(np.median(err))}


if __name__ == "__main__":
    main()
