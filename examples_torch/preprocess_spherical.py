"""Preprocess six cube-face sources into a spherical tile dataset.

Twin of examples/preprocess_spherical.py (reference
examples/preprocess_spherical.rs) on the port: the preprocessing half of
examples_torch/spherical.py, whose constants and faces it takes. On the
card the ``Preprocessor`` takes its device path.

    python examples_torch/preprocess_spherical.py [--assets DIR] [--device cpu]
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bevy_terrain_tpu_torch import (  # noqa: E402
    AttachmentConfig,
    AttachmentFormat,
    Preprocessor,
    SphericalDataset,
    TerrainConfig,
    TerrainModel,
)
from bevy_terrain_tpu_torch.terrain_data import TileAtlas  # noqa: E402
from examples_torch.spherical import (  # noqa: E402
    LOD_COUNT, MAX_HEIGHT, MIN_HEIGHT, PATH, RADIUS, TEXTURE_SIZE, synthesize_faces,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = TerrainConfig(
        lod_count=LOD_COUNT,
        model=TerrainModel.sphere(np.zeros(3), RADIUS, MIN_HEIGHT, MAX_HEIGHT),
        atlas_size=2048,
        path=PATH,
        assets_root=args.assets,
    ).add_attachment(
        AttachmentConfig(
            name="height", texture_size=TEXTURE_SIZE, border_size=2,
            mip_level_count=4, format=AttachmentFormat.R16,
        )
    )
    atlas = TileAtlas(config, args.device)
    src_dir = Path(args.assets) / "source"
    src_dir.mkdir(parents=True, exist_ok=True)
    paths, loader = synthesize_faces(src_dir)
    pre = Preprocessor(atlas, loader=loader)
    pre.clear_attachment(0).preprocess_spherical(
        SphericalDataset(attachment_index=0, paths=paths, lod_range=range(0, LOD_COUNT))
    ).run()
    n_tiles = len(atlas.state.existing_tiles)
    path = f"device ({pre.readback} read-back)" if pre.device else "host"
    print(f"dataset at {args.assets}/{PATH} ({n_tiles} tiles, {path} path)")
    return {"tiles": n_tiles, "device_path": bool(pre.device), "readback": pre.readback}


if __name__ == "__main__":
    main()
