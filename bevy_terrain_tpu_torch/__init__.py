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
``csrc/mesh_fused.cu``, with a packed albedo fused in on both); the
material frame: packed Rgba8 / Rg16 attachments, ``render/material.py``,
the attachment samplers (``csrc/attach_sample.cu``) and, for a planar
StandardMaterial over a packed albedo with the height's patch plan, the
albedo and PBR shade fused into the mesh kernel (a planet's material is
staged: mesh kernel, sampler, ``material.shade``); the staged and
per-vertex mesh paths (``csrc/fetch_resample.cu``); the device-side
queries (``Terrain.query_heights`` / ``query_attachment``), the debug
toggles with freeze, ``tune_view`` and adaptive capacity with its
same-frame overflow guard; the rasterizer (``render/raster.py``: binning,
edge functions, depth race and per-pixel shading in torch ops) and
``Terrain.render_image``; preprocessing (``Preprocessor``: source imagery to
a tile dataset, on the host or as torch ops over whole-lod stacks on the
atlas's device); the presets (``models``), the timing helpers
(``utils/timing.py``) and the frame's tracing spans and counters
(``utils/tracing.py``); the twins of ``__graft_entry__.entry`` and
``dryrun_multichip`` (``entry.py``); several views over one shared atlas,
stepped on one card, and the block store in shards (``parallel/``). The
examples and the frame bench tools are in examples_torch/ and tools_torch/
at the repo's root. Every TPU kernel of the JAX package has its CUDA
counterpart in ``ops/kernels.py``.
"""

from bevy_terrain_tpu_torch.debug import DebugTerrain
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
from bevy_terrain_tpu_torch.preprocess import PreprocessDataset, Preprocessor, SphericalDataset
from bevy_terrain_tpu_torch.render.material import (
    DirectionalLight,
    PointLight,
    SpotLight,
    StandardMaterial,
    albedo_material,
    gradient_material,
)
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.render.raster import RasterOutput, rasterize_grid, render_view
from bevy_terrain_tpu_torch.terrain_data import TileAtlas, TileTree
from bevy_terrain_tpu_torch.terrain_data.sampling_api import sample_attachment, sample_height

__all__ = [
    "AttachmentConfig",
    "AttachmentFormat",
    "Coordinate",
    "DebugTerrain",
    "DirectionalLight",
    "PointLight",
    "PreprocessDataset",
    "Preprocessor",
    "RasterOutput",
    "SphericalDataset",
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
    "rasterize_grid",
    "render_view",
    "sample_attachment",
    "sample_height",
]
