"""Synthetic terrain dataset generation.

Writes reference-format tile payloads (raw ``.bin`` + ``config.tc``) for an
analytic height function, so the streaming/rendering stack can be exercised
and golden-tested without real imagery: a planar terrain
(:func:`generate_planar_dataset`, with an analytic colour field for a
multi-channel attachment such as an Rgba8 albedo) or a cube sphere, six
sides (:func:`generate_spherical_dataset`, heights or a colour field of the
unit cube-sphere position). The payload layout matches the
reference's disk format exactly (SURVEY.md section 2 "Tile payload files").

These are test and benchmark fixtures; datasets made from source imagery
come from the ``Preprocessor`` (preprocess/). :func:`interchange_source`
and ``INTERCHANGE`` are the on-disk interchange fixture's source and
settings, whose preprocessed files have committed sha256 in
``tools/interchange_expected.json``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from bevy_terrain_tpu_torch.config import AttachmentConfig
from bevy_terrain_tpu_torch.formats.tc import TC
from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate, local_position_from_side_uv
from bevy_terrain_tpu_torch.terrain_data.attachment import data_to_bytes


def default_height_fn(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Smooth analytic normalized height in [0, 1]: a few sine octaves."""
    h = (
        0.5
        + 0.25 * np.sin(2 * np.pi * 3 * u) * np.cos(2 * np.pi * 2 * v)
        + 0.15 * np.sin(2 * np.pi * 7 * (u + v))
        + 0.10 * np.cos(2 * np.pi * 5 * (u - 0.5) * (v - 0.5) * 4)
    )
    return np.clip(h, 0.02, 1.0)  # keep away from 0 (nodata sentinel)


# the interchange fixture: a 1024^2 16-bit source preprocessed to 3 lods of
# 512^2 R16 tiles, border 2, 4 mips, on a 1000 m planar terrain 250 m high
INTERCHANGE = dict(path="terrains/interchange", terrain_size=1000.0, height=250.0,
                   texture_size=512, border_size=2, mip_count=4, lod_count=3,
                   source_size=1024)


def interchange_source(n: int = 1024) -> np.ndarray:
    """The interchange fixture's (n, n) uint16 height source, from f64
    polynomial arithmetic only (no libm), so it is the same bits on every
    platform."""
    x = (np.arange(n, dtype=np.float64) + 0.5) / n
    u, v = np.meshgrid(x, x, indexing="xy")
    # bounded polynomial "terrain": ridges from squared saw ramps
    saw3 = (3.0 * u) % 1.0
    saw5 = (5.0 * v) % 1.0
    saw7 = (7.0 * (u + v) * 0.5) % 1.0
    h = (
        0.30
        + 0.25 * (4.0 * saw3 * (1.0 - saw3))
        + 0.20 * (4.0 * saw5 * (1.0 - saw5)) * u
        + 0.15 * (4.0 * saw7 * (1.0 - saw7)) * (1.0 - v)
        + 0.05 * u * v * (1.0 - u)
    )
    return np.clip(np.rint(h * 65535.0), 0.0, 65535.0).astype(np.uint16)


def default_sphere_height_fn(p: np.ndarray) -> np.ndarray:
    """Smooth analytic normalized height in [0, 1] of a unit cube-sphere
    local position (..., 3): continuous across the six sides."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    h = 0.5 + 0.3 * np.sin(3 * x + 1) * np.cos(2 * z) + 0.15 * np.sin(7 * y + 2)
    return np.clip(h, 0.05, 1.0)  # keep away from 0 (nodata sentinel)


def default_color_fn(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Smooth analytic RGBA in [0, 1] (..., 4): red along u, green along v,
    a blue wave, opaque alpha."""
    red = 0.1 + 0.85 * u
    blue = 0.5 + 0.3 * np.sin(2 * np.pi * 4 * (u + 0.5 * v))
    return np.stack([red, v, blue, np.ones_like(u)], axis=-1)


def default_sphere_color_fn(p: np.ndarray) -> np.ndarray:
    """Smooth analytic RGBA in [0, 1] (..., 4) of a unit cube-sphere local
    position (..., 3): continuous across the six sides, red never zero,
    opaque alpha."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    red = 0.55 + 0.4 * x
    green = 0.5 + 0.45 * np.sin(2.5 * y + 0.5) * np.cos(1.5 * z)
    blue = 0.5 + 0.3 * np.sin(4 * (x + 0.5 * z))
    return np.stack([red, green, blue, np.ones_like(x)], axis=-1)


def _texel_uv(coordinate: TileCoordinate, attachment: AttachmentConfig):
    """(u, v) grids (row = v, column = u) of one tile's texel centres in
    side uv, border texels included, clamped to the side."""
    size = attachment.texture_size
    b = attachment.border_size
    center = attachment.center_size
    count = TileCoordinate.count(coordinate.lod)
    p = np.arange(size)
    # texel centers; border texels sample outside the tile (clamped to the
    # terrain so edge tiles stay consistent with clamp-repeat stitching)
    tu = (p - b + 0.5) / center
    u = np.clip((coordinate.x + tu) / count, 0.0, 1.0)
    v = np.clip((coordinate.y + tu) / count, 0.0, 1.0)
    return np.meshgrid(u, v, indexing="xy")  # row=v(y), col=u(x)


def _to_payload(field: np.ndarray, attachment: AttachmentConfig) -> np.ndarray:
    """(H, W) heights or (H, W, C) channels in [0, 1] -> the format's
    (H, W, C) texels. A multi-channel payload keeps channel 0 non-zero: 0
    is the reference's nodata sentinel (textureGather(0u) validity,
    split.wgsl:34)."""
    fmt = attachment.format
    field = field[..., None] if field.ndim == 2 else field
    if field.shape[-1] != fmt.channels:
        raise ValueError(f"the field has {field.shape[-1]} channels, {fmt.value} has "
                         f"{fmt.channels}")
    payload = (field * fmt.max_value).astype(fmt.dtype)
    if fmt.channels > 1:
        payload[..., 0] = np.maximum(payload[..., 0], 1)
    return payload


def tile_payload(
    coordinate: TileCoordinate,
    attachment: AttachmentConfig,
    height_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] = default_height_fn,
) -> np.ndarray:
    """Evaluate the analytic field over one tile incl. its border texels."""
    return _to_payload(height_fn(*_texel_uv(coordinate, attachment)), attachment)


def spherical_tile_payload(
    coordinate: TileCoordinate,
    attachment: AttachmentConfig,
    height_fn: Callable[[np.ndarray], np.ndarray] = default_sphere_height_fn,
) -> np.ndarray:
    """Evaluate an analytic field of the unit cube-sphere position over one
    tile of a side, incl. its border texels (clamped to the side)."""
    uu, vv = _texel_uv(coordinate, attachment)
    local = local_position_from_side_uv(coordinate.side, np.stack([uu, vv], axis=-1))
    return _to_payload(height_fn(local), attachment)


def generate_planar_dataset(
    path: str,
    lod_count: int,
    attachment: AttachmentConfig,
    height_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] = default_height_fn,
    root: str = "assets",
    field_fn: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
) -> list[TileCoordinate]:
    """Write all tiles of a planar terrain for lods 0..lod_count-1.

    A one-channel attachment holds ``height_fn(u, v)``; a multi-channel one
    (Rgba8, Rg16) holds ``field_fn(u, v)``, C channels in [0, 1] (default
    :func:`default_color_fn`, cut to C channels), channel 0 kept non-zero.

    Layout: ``{root}/{path}/data/{name}/{side}_{lod}_{x}_{y}.bin`` +
    ``{root}/{path}/config.tc`` (reference tile_atlas.rs:107-109,605-612).
    """
    if attachment.format.channels > 1:
        channels = attachment.format.channels
        height_fn = field_fn or (lambda u, v: default_color_fn(u, v)[..., :channels])
    data_dir = Path(root) / path / "data" / attachment.name
    data_dir.mkdir(parents=True, exist_ok=True)
    tiles = []
    for lod in range(lod_count):
        count = TileCoordinate.count(lod)
        for y in range(count):
            for x in range(count):
                c = TileCoordinate(0, lod, x, y)
                payload = tile_payload(c, attachment, height_fn)
                (data_dir / f"{c}.bin").write_bytes(data_to_bytes(payload))
                tiles.append(c)
    TC(sorted(tiles)).save_file(Path(root) / path / "config.tc")
    return tiles


def generate_spherical_dataset(
    path: str,
    lod_count: int,
    attachment: AttachmentConfig,
    height_fn: Callable[[np.ndarray], np.ndarray] = default_sphere_height_fn,
    root: str = "assets",
    field_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> list[TileCoordinate]:
    """Write all tiles of the six cube-sphere sides for lods 0..lod_count-1,
    in :func:`generate_planar_dataset`'s layout. A one-channel attachment
    holds ``height_fn`` of the unit cube-sphere position; a multi-channel
    one (Rgba8, Rg16) holds ``field_fn`` of it, C channels in [0, 1]
    (default :func:`default_sphere_color_fn`, cut to C channels), channel 0
    kept non-zero (a test fixture: real planets come from the
    preprocessor)."""
    if attachment.format.channels > 1:
        channels = attachment.format.channels
        height_fn = field_fn or (lambda p: default_sphere_color_fn(p)[..., :channels])
    data_dir = Path(root) / path / "data" / attachment.name
    data_dir.mkdir(parents=True, exist_ok=True)
    tiles = []
    for side in range(6):
        for lod in range(lod_count):
            count = TileCoordinate.count(lod)
            for y in range(count):
                for x in range(count):
                    c = TileCoordinate(side, lod, x, y)
                    payload = spherical_tile_payload(c, attachment, height_fn)
                    (data_dir / f"{c}.bin").write_bytes(data_to_bytes(payload))
                    tiles.append(c)
    TC(sorted(tiles)).save_file(Path(root) / path / "config.tc")
    return tiles
