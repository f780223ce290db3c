"""Preconfigured terrain model families.

The reference ships its configurations inside examples
(examples/{minimal,planar,spherical}.rs) — these presets capture the same
families as reusable constructors, including the flagship Earth-scale
cube-sphere used by the driver entry point and the deep-quadtree
"swisstopo-style" streaming configuration (BASELINE.json configs[4]).
"""

from __future__ import annotations

import numpy as np

from bevy_terrain_tpu_torch.config import (
    AttachmentConfig,
    AttachmentFormat,
    TerrainConfig,
    TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel


def height_attachment(texture_size: int = 512, mips: int = 4) -> AttachmentConfig:
    """The reference's standard height attachment (examples/minimal.rs:36-42)."""
    return AttachmentConfig(
        name="height",
        texture_size=texture_size,
        border_size=2,
        mip_level_count=mips,
        format=AttachmentFormat.R16,
    )


def albedo_attachment(texture_size: int = 512, mips: int = 4) -> AttachmentConfig:
    """Color attachment as used by examples/planar.rs."""
    return AttachmentConfig(
        name="albedo",
        texture_size=texture_size,
        border_size=1,
        mip_level_count=mips,
        format=AttachmentFormat.RGBA8,
    )


def planar_demo(path: str = "terrains/planar", assets_root: str = "assets") -> TerrainConfig:
    """The minimal/planar example terrain (examples/minimal.rs:5-9)."""
    return TerrainConfig(
        lod_count=4,
        model=TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0),
        atlas_size=1024,
        path=path,
        assets_root=assets_root,
        attachments=(height_attachment(),),
    )


def earth(path: str = "terrains/earth", assets_root: str = "assets",
          lod_count: int = 8) -> TerrainConfig:
    """Flagship: Earth-scale cube sphere (examples/spherical.rs scale)."""
    return TerrainConfig(
        lod_count=lod_count,
        model=TerrainModel.sphere(np.zeros(3), 6.371e6, -11_000.0, 9_000.0),
        atlas_size=2048,
        path=path,
        assets_root=assets_root,
        attachments=(height_attachment(),),
    )


def earth_ellipsoid(path: str = "terrains/earth", assets_root: str = "assets",
                    lod_count: int = 16) -> TerrainConfig:
    """WGS84-like ellipsoid at full depth (examples/spherical.rs:6-11 scale)."""
    return TerrainConfig(
        lod_count=lod_count,
        model=TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9_000.0),
        atlas_size=2048,
        path=path,
        assets_root=assets_root,
        attachments=(height_attachment(),),
    )


def streaming_flythrough_view(tile_capacity: int = 8192) -> TerrainViewConfig:
    """Deep-quadtree streaming view (the swisstopo-style flythrough load,
    BASELINE.json configs[4])."""
    return TerrainViewConfig(
        tree_size=8,
        refinement_count=30,
        grid_size=16,
        tile_capacity=tile_capacity,
    )
