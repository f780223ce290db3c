"""Preprocess a planar source image into a streamed tile dataset.

Twin of examples/preprocess_planar.py (reference
examples/preprocess_planar.rs:15-63) on the port. With no source argument
it makes a synthetic 2048^2 16-bit source in memory first (and writes it as
a PNG where PIL imports), so the example is self-contained. On the card the
``Preprocessor`` takes its device path.

    python examples_torch/preprocess_planar.py [source.png] [--assets DIR] [--device cpu]
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
    PreprocessDataset,
    Preprocessor,
    TerrainConfig,
    TerrainModel,
)
from bevy_terrain_tpu_torch.terrain_data import TileAtlas  # noqa: E402
from examples_torch import sources  # noqa: E402

PATH = "terrains/planar"
TERRAIN_SIZE = 1000.0
HEIGHT = 250.0
TEXTURE_SIZE = 512
LOD_COUNT = 4


def synthetic_source(path: Path, n: int = 2048) -> np.ndarray:
    u, v = np.meshgrid(
        (np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n, indexing="xy"
    )
    h = (
        0.5
        + 0.22 * np.sin(2 * np.pi * 3 * u) * np.cos(2 * np.pi * 2 * v)
        + 0.18 * np.sin(2 * np.pi * 9 * (u + 0.3 * v))
        + 0.05 * np.cos(2 * np.pi * 23 * u * v)
    )
    source = sources.height_source(np.clip(h, 0.02, 1.0), path)
    print(f"made synthetic source {path} ({n}x{n} u16)")
    return source


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", nargs="?", default=None)
    ap.add_argument("--assets", default="assets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = TerrainConfig(
        lod_count=LOD_COUNT,
        model=TerrainModel.planar(np.zeros(3), TERRAIN_SIZE, 0.0, HEIGHT),
        atlas_size=1024,
        path=PATH,
        assets_root=args.assets,
    ).add_attachment(
        AttachmentConfig(
            name="height",
            texture_size=TEXTURE_SIZE,
            border_size=2,
            mip_level_count=4,
            format=AttachmentFormat.R16,
        )
    )

    atlas = TileAtlas(config, args.device)
    source, loader = args.source, None
    if source is None:
        source = Path(args.assets) / "source" / "height.png"
        source.parent.mkdir(parents=True, exist_ok=True)
        loader = sources.loader({str(source): synthetic_source(source)})
    t0 = time.time()
    pre = Preprocessor(atlas, loader=loader)
    pre.clear_attachment(0).preprocess_tile(
        PreprocessDataset(attachment_index=0, path=str(source), lod_range=range(0, LOD_COUNT))
    ).run()
    n_tiles = len(atlas.state.existing_tiles)
    dt = time.time() - t0
    path = f"device ({pre.readback} read-back)" if pre.device else "host"
    print(f"preprocessed {n_tiles} tiles in {dt:.2f}s ({n_tiles / dt:.1f} tiles/s) "
          f"on the {path} path")
    print(f"dataset at {args.assets}/{PATH}")
    return {"tiles": n_tiles, "seconds": dt, "device_path": bool(pre.device),
            "readback": pre.readback}


if __name__ == "__main__":
    main()
