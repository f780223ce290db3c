"""The per-frame terrain pipeline: host prologue + the device frame stage.

Torch twin of the JAX package's ``render/pipeline.py``:

1. a host prologue per view (f64 numpy): request scan, residency update,
   best-tile entries, approximate height, Taylor approximation, and ONE
   packed int32 uniform blob;
2. the device stage, eager torch on the atlas's device: unpack the blob,
   refine the tile list, then the mesh by one of three paths:

   * fused (grid size 16; planar without the Taylor high-precision path,
     or spherical with it): plan the patch fetches and run the fused mesh
     kernel (``ops/kernels.mesh_fused_planar`` for planar terrains,
     ``ops/kernels.mesh_fused_spherical`` for spheres and ellipsoids);
   * staged (any other view configuration: a sphere without the Taylor
     path, a planar terrain with it, another grid size):
     ``ops/meshgen.generate_mesh_grid``, whose half-grid comes from
     ``ops/kernels.fetch_resample_cached`` at grid size 16;
   * per vertex (a height attachment too small for the patch plan):
     ``ops/meshgen.generate_mesh``, bilinear gathers from the height slab,
     no hand-written kernel;
3. with ``set_shading``, on the fused and staged paths, the material stage.
   A planar fused frame lit by a
   :class:`~render.material.StandardMaterial` whose base colour is the one
   sampled packed Rgba8 albedo (``albedo_material``), with the height
   attachment's patch plan, no debug view, no wireframe and no shadow
   hook, runs it inside the mesh kernel (``ops/kernels.mesh_fused_shaded``,
   the colours ride the raw tensor). Any other material is staged: the
   named attachments sampled at the mesh's morphed uvs (an attachment with
   the height attachment's patch plan, at grid size 16, through
   ``ops/kernels.attach_sample_fused[_packed]``; one with another plan, or
   at another grid size, through the staged sampler of
   ``ops/patch_sampling``), then ``render/material.shade``.

The device stage reads no device value on the host except the refinement
spill loop's queue count, so PyTorch's asynchronous launches let the next
frame's host prologue overlap most of it.

A sampled attachment without a usable patch plan and the multi-tap
gradient sampler raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import TerrainConfig, TerrainViewConfig
from bevy_terrain_tpu_torch.math.approximation import TerrainModelApproximation
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement
from bevy_terrain_tpu_torch.ops.patch_sampling import sample_attachment_vertices
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig,
    pack_frame_uniforms,
    unpack_frame_uniforms,
)
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas
from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree


class FusedMaterial(NamedTuple):
    """A material stage that runs inside the mesh kernel
    (Terrain._select_fused_material)."""

    shade: torch.Tensor  # kernels.pack_shade_spec buffer
    channels: int  # albedo channels the kernel samples
    bits: int  # bits per packed channel
    index: int  # the sampled attachment


class TerrainFrameOutput:
    """One view's frame products: the sorted tile list + the mesh.

    ``tiles`` and the mesh live on the device. On the fused path the frame
    holds the kernel's ``raw_mesh`` and ``mesh`` (the GridMeshOutput view)
    is made on first access; the staged and per-vertex paths hand over a
    ready ``mesh`` (a GridMeshOutput, or a MeshOutput in strip order) and
    have no raw tensor. ``colors`` (of an in-kernel shade), ``tile_count``
    and ``overflow`` are computed on first access; the two counts read the
    device (one sync each).
    """

    def __init__(self, tiles: refinement.RefinementOutput, raw: Optional[torch.Tensor],
                 cfg: StaticTerrainConfig, mesh_inputs: tuple = (),
                 colors: Optional[torch.Tensor] = None, shaded_channels: int = 0, mesh=None):
        self.tiles = tiles
        self._raw = raw
        self._cfg = cfg
        self._mesh = mesh
        self._colors = colors
        self._shaded_channels = shaded_channels
        self.mesh_inputs = mesh_inputs

    @property
    def raw_mesh(self) -> Optional[torch.Tensor]:
        """The fused kernel's product (None on the staged and per-vertex
        paths), rows paired with ``tiles``, on the
        (row = v, column = u) vertex grid: (Fp, 6, 17, 17) f32 for a planar
        terrain, per tile the channels [height, pos x, pos y, pos z,
        morphed u, morphed v], followed by the shaded linear RGBA (or RGB)
        when the material ran in the kernel;
        (Fp, 9, 17, 17) for a sphere
        or ellipsoid, which adds the unit world normal [n x, n y, n z]."""
        return self._raw

    @property
    def mesh(self) -> "meshgen.GridMeshOutput | meshgen.MeshOutput":
        if self._mesh is None:
            self._mesh = meshgen.fused_to_grid(self._raw, self.tiles, self._cfg)
        return self._mesh

    @property
    def colors(self) -> Optional[torch.Tensor]:
        """(F, G+1, G+1, 4) f32 linear RGBA with shading on, else None. An
        in-kernel opaque shade (3 channels) pads alpha with the tile's
        liveness, so dead capacity reads alpha 0 as in the 4-channel kernel
        (a live tile without atlas data pads alpha 1; its RGB is 0)."""
        if self._colors is None and self._shaded_channels:
            rgba = meshgen.fused_albedo_to_grid(self._raw, self._cfg, self._shaded_channels, 1.0)
            if self._shaded_channels == 3:
                F = self._cfg.tile_capacity
                live = (torch.arange(F, dtype=torch.int32, device=rgba.device)
                        < self.tiles.tile_count).to(rgba.dtype)
                rgba = torch.cat([rgba, live[:, None, None, None].expand(rgba.shape[:-1] + (1,))],
                                 dim=-1)
            self._colors = rgba
        return self._colors

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
        if not config.attachments:
            raise NotImplementedError("the torch frame needs a height attachment")
        self.config = config
        self.device = torch.device(device)
        self.atlas = TileAtlas(config, self.device)
        # the patch pipeline (fused or staged grid mesh); a height attachment
        # too small for it falls back to the exact per-vertex path
        self.use_grid_mesh = self.atlas.attachments[0].patch_plan.usable
        self.tile_trees: dict[object, TileTree] = {}
        self.view_configs: dict[object, TerrainViewConfig] = {}
        self._static_cfgs: dict[object, StaticTerrainConfig] = {}
        self._last_blobs: dict[object, torch.Tensor] = {}
        self.frame_index = 0
        # the material (a callable of render.material.ShadeContext); None
        # with _shade_opts None = vertex buffers only, until set_shading()
        self.shading_fn = shading_fn
        self._shade_opts = None
        # set when the whole material stage runs in the mesh kernel
        self._fused_material: Optional[FusedMaterial] = None

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

    def set_shading(self, material=None, lighting: bool = True, debug_view=None,
                    enabled: bool = True, wireframe: bool = False,
                    sample_attachments: tuple = ()) -> None:
        """Shade every frame (the fragment stage; see render/material.py).

        ``sample_attachments``: attachment indices (e.g. ``(1,)`` for the
        planar example's albedo) sampled at the frame's morphed vertex uvs
        and handed to the material as ``ShadeContext.attachment_samples``.
        An attachment with the height attachment's patch plan goes through
        the sampler kernels, one with another plan (a border-1 albedo beside
        a border-2 height) through the staged sampler; one without a usable
        patch plan raises ``NotImplementedError``. The per-vertex path (a
        height attachment too small for the patch plan) does not shade."""
        height = self.atlas.attachments[0]
        for idx in sample_attachments:
            att = self.atlas.attachments[idx]
            if att.block_array is None:
                raise NotImplementedError(
                    f"attachment {idx} ({att.name!r}) is too small for the patch plan "
                    f"and cannot be sampled at the mesh's vertices")
        self.shading_fn = material
        self._shade_opts = (
            (lighting, debug_view, height.config.texture_size, wireframe,
             tuple(sample_attachments))
            if enabled else None
        )
        self._fused_material = self._select_fused_material()

    def _select_fused_material(self):
        """The material stage that runs inside the mesh kernel of a planar
        frame (the JAX pipeline's fused_shade selection), or None (staged):
        lighting on, no debug view, no wireframe, ONE sampled attachment,
        packed with 4 channels and the height's plan, and a StandardMaterial
        over albedo_material of that attachment whose kernel_shade_spec
        exists (no shadow hook). An opaque base colour samples 3 channels."""
        if self._shade_opts is None:
            return None
        lighting, debug_view, _, wireframe, samples = self._shade_opts
        material = self.shading_fn
        if not lighting or debug_view is not None or wireframe or len(samples) != 1:
            return None
        idx = samples[0]
        att = self.atlas.attachments[idx]
        channels = att.config.format.channels if att.block_packed else 0
        if channels != 4 or att.patch_plan != self.atlas.attachments[0].patch_plan:
            return None
        if (not isinstance(material, mat.StandardMaterial)
                or getattr(material.base_color, "attachment_index", None) != idx):
            return None
        spec = mat.kernel_shade_spec(material, att.config.format.max_value)
        if spec is None:
            return None
        return FusedMaterial(kernels.pack_shade_spec(spec, self.device),
                             3 if material.opaque_base_color else channels, att.packed_bits,
                             idx)

    # -- device stage --

    @staticmethod
    def use_fused(cfg: StaticTerrainConfig) -> bool:
        """The single-kernel fused mesh path covers planar and
        spherical-with-Taylor frames at grid size 16 (its blend is always
        per vertex); every other view configuration takes the staged path."""
        return cfg.grid_size == 16 and cfg.spherical == cfg.high_precision

    @staticmethod
    def frame_step(block_array: torch.Tensor, uniform_blob: torch.Tensor,
                   cfg: StaticTerrainConfig, plan, max_value: float, albedo_blocks=None,
                   albedo_channels: int = 0, albedo_bits: int = 0, shade_spec=None):
        """unpack -> refine -> the mesh: patch plan + fused mesh kernel (with
        the albedo and its shade fused in when given;
        meshgen.fused_kernel_args) where :meth:`use_fused` holds, else
        meshgen.generate_mesh_grid.

        Returns (sorted tiles, the fused kernel's raw mesh or the staged
        path's GridMeshOutput, mesh kernel inputs (fused only), uniforms)."""
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        tiles = refinement.refine_tiles(uniforms, cfg)
        if not Terrain.use_fused(cfg):
            mesh, tiles = meshgen.generate_mesh_grid(tiles, block_array, uniforms, cfg, plan,
                                                     max_value)
            return tiles, mesh, (), uniforms
        tiles, _, args = meshgen.fused_kernel_args(
            tiles, block_array, uniforms, cfg, plan, max_value, albedo_blocks,
            albedo_channels, albedo_bits, shade_spec,
        )
        kernel = meshgen.mesh_kernel(cfg, albedo_channels, shade_spec is not None)
        return tiles, kernel(*args), args, uniforms

    @staticmethod
    def frame_step_vertex(height_slab: torch.Tensor, uniform_blob: torch.Tensor,
                          cfg: StaticTerrainConfig, attachment_scale: float,
                          attachment_offset: float):
        """The per-vertex device stage: unpack -> refine ->
        meshgen.generate_mesh on the height slab. Returns (tiles,
        MeshOutput)."""
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        tiles = refinement.refine_tiles(uniforms, cfg)
        return tiles, meshgen.generate_mesh(tiles, height_slab, uniforms, cfg,
                                            attachment_scale, attachment_offset)

    def _sample(self, idx: int, tiles, mesh, uniforms, cfg) -> torch.Tensor:
        """Attachment ``idx`` at the mesh's morphed vertex uvs, (F, G+1, G+1,
        C) in [0, 1]."""
        att = self.atlas.attachments[idx]
        return sample_attachment_vertices(
            att.block_arrays, tiles, mesh.uvs, uniforms, cfg, att.patch_plan,
            att.config.format.max_value,
            plan_matches_frame=att.patch_plan == self.atlas.attachments[0].patch_plan,
            packed_channels=att.config.format.channels if att.block_packed else 0,
            packed_bits=att.packed_bits,
        )

    def _maybe_shade(self, mesh, tiles, uniforms, cfg) -> Optional[torch.Tensor]:
        """The staged material stage: sample the named attachments, then
        render.material.shade on the mesh."""
        if self._shade_opts is None:
            return None
        lighting, debug_view, texture_size, wireframe, samples = self._shade_opts
        attachment_samples = {idx: self._sample(idx, tiles, mesh, uniforms, cfg)
                              for idx in samples} or None
        return mat.shade(
            mesh, tiles, uniforms, cfg, material=self.shading_fn, lighting=lighting,
            debug_view=debug_view, texture_size=texture_size, wireframe=wireframe,
            attachment_samples=attachment_samples,
        )

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
            self._last_blobs[view_id] = blob_dev
            if not self.use_grid_mesh:
                tiles, mesh = self.frame_step_vertex(
                    height.slabs[0], blob_dev, cfg, height.config.scale, height.config.offset)
                outputs[view_id] = TerrainFrameOutput(tiles, None, cfg, mesh=mesh)
                continue
            fused = None
            if self.use_fused(cfg) and not cfg.spherical:
                fused = self._fused_material
            albedo = {}
            if fused is not None:
                albedo = dict(albedo_blocks=self.atlas.attachments[fused.index].block_array,
                              albedo_channels=fused.channels, albedo_bits=fused.bits,
                              shade_spec=fused.shade)
            tiles, product, args, uniforms = self.frame_step(
                height.block_array, blob_dev, cfg, height.patch_plan,
                height.config.format.max_value, **albedo,
            )
            # the fused step hands over the kernel's raw tensor (its grid
            # view is made on first access), the staged step a ready mesh
            raw = product if isinstance(product, torch.Tensor) else None
            colors = None
            if fused is None and self._shade_opts is not None:
                mesh = product if raw is None else meshgen.fused_to_grid(raw, tiles, cfg)
                colors = self._maybe_shade(mesh, tiles, uniforms, cfg)
            outputs[view_id] = TerrainFrameOutput(
                tiles, raw, cfg, args, colors, fused.channels if fused else 0,
                mesh=product if raw is None else None)
        self.frame_index += 1
        return outputs

    def last_uniform_blob(self, view_id) -> np.ndarray:
        """The packed uniform blob of the view's last frame, on the host."""
        return self._last_blobs[view_id].cpu().numpy()

    def sample_attachment_grid(self, view_id, frame_output: TerrainFrameOutput,
                               attachment_index: int, grad_taps: int = 1) -> torch.Tensor:
        """Sample an attachment (albedo, splat, ...) at the frame's morphed
        vertex uvs, the fragment-stage attachment fetch for custom materials
        (attachments.wgsl:12-43), with the view's last uniforms. Returns
        (F, G+1, G+1, C) f32 in [0, 1]. ``grad_taps > 1`` (the anisotropic
        multi-tap sampler) is not ported yet."""
        if grad_taps > 1:
            raise NotImplementedError("the multi-tap gradient sampler is not ported yet")
        if not self.use_grid_mesh:
            raise RuntimeError("sample_attachment_grid requires the grid mesh path")
        att = self.atlas.attachments[attachment_index]
        if att.block_array is None:
            raise NotImplementedError(
                f"attachment {attachment_index} ({att.name!r}) is too small for the patch "
                f"plan and cannot be sampled at the mesh's vertices")
        cfg = self._static_cfgs[view_id]
        uniforms = unpack_frame_uniforms(self._last_blobs[view_id], cfg.side_count,
                                         cfg.lod_count, cfg.tree_size)
        return self._sample(attachment_index, frame_output.tiles, frame_output.mesh, uniforms,
                            cfg)
