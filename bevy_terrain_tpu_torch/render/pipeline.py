"""The per-frame terrain pipeline: host prologue + the device frame stage.

Torch twin of the fused branch of the JAX package's ``render/pipeline.py``:

1. a host prologue per view (f64 numpy): request scan, residency update,
   best-tile entries, approximate height, Taylor approximation, and ONE
   packed int32 uniform blob;
2. the device stage, eager torch on the atlas's device: unpack the blob,
   refine the tile list, plan the patch fetches, and run the fused mesh
   kernel (``ops/kernels.mesh_fused_planar`` for planar terrains,
   ``ops/kernels.mesh_fused_spherical`` for spheres and ellipsoids, with
   the Taylor high-precision path).

The device stage reads no device value on the host except the refinement
spill loop's queue count, so PyTorch's asynchronous launches let the next
frame's host prologue overlap most of it.

Only the height-only frame at grid size 16 is ported. Another grid size, a
sphere without the high-precision path, an attachment without a usable
patch plan, and shading raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import TerrainConfig, TerrainViewConfig
from bevy_terrain_tpu_torch.math.approximation import TerrainModelApproximation
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig,
    pack_frame_uniforms,
    unpack_frame_uniforms,
)
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas
from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree


class TerrainFrameOutput:
    """One view's frame products: the sorted tile list + the kernel's mesh.

    ``tiles`` and ``raw_mesh`` live on the device. ``mesh`` (the
    GridMeshOutput view), ``tile_count`` and ``overflow`` are computed on
    first access; the two counts read the device (one sync each).
    """

    def __init__(self, tiles: refinement.RefinementOutput, raw: torch.Tensor,
                 cfg: StaticTerrainConfig, mesh_inputs: tuple):
        self.tiles = tiles
        self._raw = raw
        self._cfg = cfg
        self._mesh = None
        self.mesh_inputs = mesh_inputs

    @property
    def raw_mesh(self) -> torch.Tensor:
        """The fused kernel's product, rows paired with ``tiles``, on the
        (row = v, column = u) vertex grid: (Fp, 6, 17, 17) f32 for a planar
        terrain, per tile the channels [height, pos x, pos y, pos z,
        morphed u, morphed v]; (Fp, 9, 17, 17) for a sphere or ellipsoid,
        which adds the unit world normal [n x, n y, n z]."""
        return self._raw

    @property
    def mesh(self) -> meshgen.GridMeshOutput:
        if self._mesh is None:
            self._mesh = meshgen.fused_to_grid(self._raw, self.tiles, self._cfg)
        return self._mesh

    @property
    def tile_count(self) -> int:
        return int(self.tiles.tile_count)

    @property
    def overflow(self) -> int:
        """Tiles dropped by the static capacity clamps this frame; nonzero
        means geometry was missing (raise tile_capacity / queue_capacity)."""
        return int(self.tiles.overflow)


class Terrain:
    """A terrain with its atlas and per-view tile trees::

        terrain = Terrain(config)  # on the CUDA card; device="cpu" asks for the CPU
        terrain.add_view("camera", TerrainViewConfig())
        outputs = terrain.update({"camera": view_position})
    """

    def __init__(self, config: TerrainConfig, device="cuda", shading_fn=None):
        if config.model is None:
            raise ValueError("TerrainConfig.model is required")
        if shading_fn is not None:
            raise NotImplementedError("shading is not ported to the torch package yet")
        if not config.attachments:
            raise NotImplementedError("the torch frame needs a height attachment")
        self.config = config
        self.device = torch.device(device)
        self.atlas = TileAtlas(config, self.device)
        if not self.atlas.attachments[0].patch_plan.usable:
            raise NotImplementedError(
                "the height attachment is too small for the patch plan; the "
                "per-vertex mesh path is not ported to the torch package yet")
        self.tile_trees: dict[object, TileTree] = {}
        self.view_configs: dict[object, TerrainViewConfig] = {}
        self._static_cfgs: dict[object, StaticTerrainConfig] = {}
        self._last_blobs: dict[object, torch.Tensor] = {}
        self.frame_index = 0

    # -- setup --

    def add_view(self, view_id, view_config: Optional[TerrainViewConfig] = None,
                 queue_capacity: int = 8192, **static_overrides) -> None:
        view_config = view_config or TerrainViewConfig()
        model = self.config.model
        cfg = StaticTerrainConfig(
            spherical=model.is_spherical,
            side_count=model.side_count,
            lod_count=self.config.lod_count,
            tree_size=view_config.tree_size,
            grid_size=view_config.grid_size,
            refinement_count=view_config.refinement_count,
            queue_capacity=queue_capacity,
            tile_capacity=view_config.tile_capacity,
            origin_lod=view_config.origin_lod,
            attachment_count=len(self.config.attachments),
            **{
                "high_precision": model.is_spherical,
                "ellipsoidal": model.kind == "ellipsoidal",
                **static_overrides,
            },
        )
        meshgen.check_fused_config(cfg)
        self.view_configs[view_id] = view_config
        self.tile_trees[view_id] = TileTree(self.atlas, view_config)
        self._static_cfgs[view_id] = cfg

    def remove_view(self, view_id) -> None:
        """Release every tile the view still holds, then drop it."""
        tree = self.tile_trees.pop(view_id)
        self.view_configs.pop(view_id)
        self._static_cfgs.pop(view_id)
        self._last_blobs.pop(view_id, None)
        held = tree._collect(tree.tile_requested, tree.tile_xy)
        self.atlas.update(released_tiles=held)

    def set_shading(self, *args, **kwargs) -> None:
        raise NotImplementedError("shading is not ported to the torch package yet")

    # -- device stage --

    @staticmethod
    def frame_step(block_array: torch.Tensor, uniform_blob: torch.Tensor,
                   cfg: StaticTerrainConfig, plan, max_value: float):
        """unpack -> refine -> patch plan -> fused mesh kernel.

        Returns (sorted tiles, raw mesh, mesh kernel inputs)."""
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        tiles = refinement.refine_tiles(uniforms, cfg)
        tiles, _, args = meshgen.fused_kernel_args(
            tiles, block_array, uniforms, cfg, plan, max_value
        )
        return tiles, meshgen.mesh_kernel(cfg)(*args), args

    # -- per-frame orchestration (reference plugin.rs:46-56 Last schedule) --

    def update(self, view_positions: dict,
               view_projections: dict | None = None) -> dict[object, TerrainFrameOutput]:
        """Run one frame for every view.

        ``view_projections`` (optional): per-view 4x4 view-projection
        matrices (math/frustum.py helpers), needed for views whose static
        config enables ``culling``.
        """
        view_projections = view_projections or {}
        # 1. request scans (TileTree::compute_requests, plugin.rs:47)
        released, requested = [], []
        for view_id, pos in view_positions.items():
            tree = self.tile_trees[view_id]
            tree.compute_requests(pos)
            released.extend(tree.released_tiles)
            requested.extend(tree.requested_tiles)

        # 2. atlas residency + IO (TileAtlas::update, plugin.rs:49)
        self.atlas.update(released, requested)
        self.atlas.flush_uploads()

        # 3.-5. per view: adjust entries, height probe, approximation,
        # device stage (plugin.rs:50-55 + render schedule)
        height = self.atlas.attachments[0]
        outputs = {}
        for view_id, pos in view_positions.items():
            tree = self.tile_trees[view_id]
            tree.adjust_to_tile_atlas(self.atlas)
            tree.update_approximate_height(self.atlas)
            approx = TerrainModelApproximation.compute(
                self.config.model, pos, tree.origin_lod, tree.approximate_height
            )
            blob = pack_frame_uniforms(
                self.config.model, pos, approx, tree.origins, tree.entries,
                tree.view_tile_int, tree.view_tile_frac,
                self.view_configs[view_id],
                view_proj=view_projections.get(view_id),
            )
            blob_dev = interop.blob_to_device(blob, self.device)  # ONE copy per frame
            cfg = self._static_cfgs[view_id]
            tiles, raw, args = self.frame_step(
                height.block_array, blob_dev, cfg, height.patch_plan,
                height.config.format.max_value,
            )
            outputs[view_id] = TerrainFrameOutput(tiles, raw, cfg, args)
            self._last_blobs[view_id] = blob_dev
        self.frame_index += 1
        return outputs

    def last_uniform_blob(self, view_id) -> np.ndarray:
        """The packed uniform blob of the view's last frame, on the host."""
        return self._last_blobs[view_id].cpu().numpy()
