"""bevy_terrain_tpu_torch — the terrain engine in PyTorch, with hand-written
CUDA kernels for one NVIDIA H100 (sm_90a).

The port of the JAX package (JAX / Pallas on a TPU), which stays the
reference. The layout and names follow that package module for module.
This package imports torch and numpy, and neither jax nor the JAX package:
the host modules it shares with the JAX package are carried as copies
(importing any module of the JAX package runs its ``__init__``, which
imports jax).

Ported so far: the planar and the spherical frame (host prologue, packed
uniforms, refinement, patch plan and the fused mesh kernels,
``csrc/mesh_fused.cu``), and the material frame: packed Rgba8 / Rg16
attachments, ``render/material.py``, the attachment samplers
(``csrc/attach_sample.cu``) and, for a planar StandardMaterial over a
packed albedo with the height's patch plan, the albedo and PBR shade fused
into the mesh kernel.
"""

from bevy_terrain_tpu_torch.config import (
    AttachmentConfig,
    AttachmentFormat,
    TerrainConfig,
    TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import (
    Coordinate,
    TerrainModel,
    TerrainModelApproximation,
    TileCoordinate,
)
from bevy_terrain_tpu_torch.render.material import (
    DirectionalLight,
    PointLight,
    SpotLight,
    StandardMaterial,
    albedo_material,
    gradient_material,
)
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.terrain_data import TileAtlas, TileTree

__all__ = [
    "AttachmentConfig",
    "AttachmentFormat",
    "Coordinate",
    "DirectionalLight",
    "PointLight",
    "SpotLight",
    "StandardMaterial",
    "Terrain",
    "TerrainConfig",
    "TerrainFrameOutput",
    "TerrainModel",
    "TerrainModelApproximation",
    "TerrainViewConfig",
    "TileAtlas",
    "TileCoordinate",
    "TileTree",
    "albedo_material",
    "gradient_material",
]
