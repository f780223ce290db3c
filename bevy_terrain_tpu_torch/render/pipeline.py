"""The per-frame terrain pipeline: host prologue + the device frame stage.

Torch twin of the JAX package's ``render/pipeline.py``:

1. a host prologue per view (f64 numpy): request scan, residency update,
   best-tile entries, approximate height, Taylor approximation, and ONE
   packed int32 uniform blob;
2. the device stage, eager torch on the atlas's device: unpack the blob,
   refine the tile list, then the mesh by one of three paths. The view's
   ``pallas_sampling`` switch (the JAX package's name) picks the hand
   kernels. By default it is on where the terrain runs on the card and the
   grid size is 16, and off on the CPU, as the JAX package's is off away
   from the TPU; ``add_view(..., pallas_sampling=False)`` runs the frame on
   the card in torch ops alone:

   * fused (``pallas_sampling``, grid size 16; planar without the Taylor
     high-precision path, or spherical with it): plan the patch fetches and
     run the fused mesh kernel (``ops/kernels.mesh_fused_planar`` for
     planar terrains, ``ops/kernels.mesh_fused_spherical`` for spheres and
     ellipsoids);
   * staged (any other view configuration: the switch off, a sphere
     without the Taylor path, a planar terrain with it, another grid
     size): ``ops/meshgen.generate_mesh_grid``, whose half-grid comes from
     ``ops/kernels.fetch_resample_cached`` with the switch on at grid size
     16, else from torch ops;
   * per vertex (a height attachment too small for the patch plan):
     ``ops/meshgen.generate_mesh``, bilinear gathers from the height slab,
     no hand-written kernel;
3. with ``set_shading``, on the fused and staged paths, the material stage.
   A planar fused frame lit by a
   :class:`~render.material.StandardMaterial` whose base colour is the one
   sampled packed Rgba8 albedo (``albedo_material``), with the height
   attachment's patch plan, no debug view, no wireframe and no shadow
   hook, runs it inside the mesh kernel (``ops/kernels.mesh_fused_shaded``,
   the colours ride the raw tensor). Any other material, and every
   material of a planet (the in-kernel shade's normals are a planar
   central difference; ``shade`` takes the spherical kernel's unit
   normals), is staged: the
   named attachments sampled at the mesh's morphed uvs (an attachment with
   the height attachment's patch plan, at grid size 16 with the switch on,
   through ``ops/kernels.attach_sample_fused[_packed]``; one with another
   plan, at another grid size or with the switch off, through the staged
   sampler of ``ops/patch_sampling``), then ``render/material.shade``.

The device stage reads no device value on the host except the refinement
spill loop's queue count, so PyTorch's asynchronous launches let the next
frame's host prologue overlap most of it. With adaptive capacity
(:meth:`Terrain.enable_adaptive_capacity`) the tile count comes back through
a pinned, non-blocking copy harvested the next frame; only a frame the
host suspects of a tile-count spike reads its overflow counter at once.

Beside the frame: :meth:`Terrain.query_heights` /
:meth:`Terrain.query_attachment` (batched world-position queries on the
terrain's device, against the view's last uniforms, ``ops/sampling.py``),
:meth:`Terrain.render_image` (the rasterizer of ``render/raster.py`` on a
frame output), :meth:`Terrain.frame_inputs`, :meth:`Terrain.set_debug` (the DebugTerrain
toggles; ``freeze`` pins the tile list), :meth:`Terrain.tune_view`.

A sampled attachment without a usable patch plan raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import TerrainConfig, TerrainViewConfig
from bevy_terrain_tpu_torch.math.approximation import TerrainModelApproximation
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement, sampling
from bevy_terrain_tpu_torch.ops.patch_sampling import (
    sample_attachment_vertices,
    sample_attachment_vertices_grad,
)
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig,
    pack_frame_uniforms,
    unpack_frame_uniforms,
)
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas
from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree
from bevy_terrain_tpu_torch.utils import tracing


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
        # the config each view's last frame ran with (an adaptive-capacity
        # rung where that is on)
        self._last_frame_cfgs: dict[object, StaticTerrainConfig] = {}
        self._adaptive: dict[object, dict] = {}
        # overflow guard bookkeeping (_spike_suspected): (position, height
        # above the terrain) per view, and two counters
        self._last_view_pos: dict = {}
        self.overflow_redispatches = 0
        self.overflow_checks = 0
        # freeze (reference debug/mod.rs:186-192: the prepass is skipped and
        # the last tile list is drawn again from the new camera)
        self.debug = None
        self._frozen_tiles: dict[object, refinement.RefinementOutput] = {}
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
                "pallas_sampling": self.device.type == "cuda"
                and view_config.grid_size == 16,
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
        self._adaptive.pop(view_id, None)
        for state in (self._last_blobs, self._last_frame_cfgs, self._last_view_pos,
                      self._frozen_tiles):
            state.pop(view_id, None)
        held = tree._collect(tree.tile_requested, tree.tile_xy)
        self.atlas.update(released_tiles=held)

    def set_debug(self, debug) -> None:
        """Apply a DebugTerrain resource (reference debug/mod.rs:94-260).

        The pipeline-specialization toggles (morph, blend, tile_tree_lod,
        sample_grad, test1-3) rebuild each view's static config, like the
        reference's shader-def respecialization; the view toggles select the
        debug colour output; ``freeze`` pins every view's tile list until
        released."""
        self.debug = debug
        if debug is None:
            self._frozen_tiles.clear()
            return
        for view_id in list(self._static_cfgs):
            self._static_cfgs[view_id] = dataclasses.replace(
                self._static_cfgs[view_id], **debug.static_overrides())
        if debug.debug_view is not None or debug.wireframe or self._shade_opts is not None:
            self.set_shading(
                self.shading_fn, lighting=debug.lighting, debug_view=debug.debug_view,
                wireframe=debug.wireframe,
                sample_attachments=self._shade_opts[4] if self._shade_opts else ())
        if not debug.freeze:
            self._frozen_tiles.clear()

    def tune_view(self, view_id, **changes) -> None:
        """Runtime view-parameter tuning (reference debug/mod.rs:216-260:
        morph / blend / load distance and grid-size halving and doubling).

        Distance and range changes flow into the next frame's uniforms;
        ``grid_size`` / ``tree_size`` / ``tile_capacity`` changes rebuild
        the TileTree and the static config (a respecialization, like the
        reference swapping pipelines)."""
        old = self.view_configs[view_id]
        new = dataclasses.replace(old, **changes)
        self.view_configs[view_id] = new
        tree = self.tile_trees[view_id]
        if {"tree_size", "grid_size", "tile_capacity"} & set(changes):
            held = tree._collect(tree.tile_requested, tree.tile_xy)
            self.atlas.update(released_tiles=held)
            cfg = self._static_cfgs[view_id]
            overrides = {f: getattr(cfg, f) for f in (
                "morph", "blend", "tile_tree_lod", "sample_grad", "culling", "high_precision")}
            self.add_view(view_id, new, queue_capacity=cfg.queue_capacity, **overrides)
        else:
            scale = self.config.model.scale
            tree.view_config = new
            tree.morph_distance = new.morph_distance * scale
            tree.blend_distance = new.blend_distance * scale
            tree.load_distance = new.load_distance * scale
            tree.subdivision_distance = (
                new.morph_distance * scale * (1.0 + new.subdivision_tolerance))
            tree.morph_range = new.morph_range
            tree.blend_range = new.blend_range
        self._frozen_tiles.pop(view_id, None)

    # -- adaptive capacity --

    def enable_adaptive_capacity(self, view_id, ladder=None, headroom: float = 2.0) -> None:
        """Adapt the frame stage's tile_capacity to the live tile count.

        Every tensor of the stage is ``tile_capacity`` wide, whatever the
        tiles actually emitted. This runs the stage over a capacity ladder,
        choosing the smallest rung >= ``headroom`` x the PREVIOUS frame's
        tile count. The count comes back asynchronously (a non-blocking copy
        into pinned memory at dispatch, harvested the next frame), so no
        device sync stalls the loop. A sudden tile-count spike (a teleport,
        a fast cut) is caught the SAME frame: a host-side heuristic
        (:meth:`_spike_suspected`: camera jump against the height above the
        terrain, a burst of the request scan) triggers a synchronous
        overflow check, and the frame is dispatched again at the next rung
        until clean (:meth:`_overflow_guard`), so no frame drops geometry;
        the sync is paid on suspect frames only. Off while freeze debugging
        pins a tile list (shapes must match the frozen tensors)."""
        cap = self.view_configs[view_id].tile_capacity
        if ladder is None:
            ladder, c = [], cap
            while c >= 1024:
                ladder.append(c)
                c //= 2
        ladder = sorted({min(int(c), cap) for c in ladder} | {cap})
        self._adaptive[view_id] = {
            "ladder": ladder, "headroom": float(headroom),
            "pending": None, "last_count": cap, "capacity": cap,
        }

    def disable_adaptive_capacity(self, view_id) -> None:
        self._adaptive.pop(view_id, None)

    def _adapted_cfg(self, view_id, frozen: bool) -> StaticTerrainConfig:
        """The frame's static config: the capacity-ladder rung when adaptive
        capacity is on, else the view's full config. Frozen frames pin the
        full capacity."""
        cfg = self._static_cfgs[view_id]
        ad = self._adaptive.get(view_id)
        if ad is None or frozen:
            return cfg
        if ad["pending"] is not None:
            host, event = ad["pending"]
            if event is not None:
                event.synchronize()  # last frame's copy: long done
            ad["last_count"] = int(host)
            ad["pending"] = None
        want = ad["last_count"] * ad["headroom"]
        cap = next((c for c in ad["ladder"] if c >= want), ad["ladder"][-1])
        ad["capacity"] = cap
        if cap != cfg.tile_capacity:
            cfg = dataclasses.replace(cfg, tile_capacity=cap)
        return cfg

    def _read_count_async(self, view_id, tiles) -> None:
        """Start the tile count's copy to the host for the next frame's
        :meth:`_adapted_cfg`."""
        ad = self._adaptive.get(view_id)
        if ad is None:
            return
        count = tiles.tile_count.reshape(1)
        if count.device.type != "cuda":
            ad["pending"] = (count.clone(), None)
            return
        host = torch.empty(1, dtype=count.dtype, pin_memory=True)
        host.copy_(count, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        ad["pending"] = (host, event)

    def _spike_suspected(self, view_id, pos, n_requested: int,
                         approximate_height: float) -> bool:
        """Host-side tile-count-spike heuristic for the overflow guard.

        The refined tile count is a function of the camera relative to the
        surface; it can only jump when the camera moves a distance
        comparable to its height above the terrain (the deepest lod's
        subdivision radii are O(height)) or when the request scan bursts
        (new area streaming in). Both signals are free on the host, so the
        guard's device sync is paid only on suspect frames."""
        pos = np.asarray(pos, np.float64).reshape(3)
        surf = np.asarray(self.config.model.surface_position(pos, approximate_height),
                          np.float64)
        h = float(np.linalg.norm(pos - surf))
        prev = self._last_view_pos.get(view_id)
        self._last_view_pos[view_id] = (pos, h)
        if prev is None:
            return True  # first frame
        ppos, ph = prev
        if float(np.linalg.norm(pos - ppos)) > 0.3 * max(min(ph, h), 1e-9):
            return True
        cap = self._adaptive[view_id]["capacity"]
        return n_requested > max(16, cap // 16)

    def _overflow_guard(self, view_id, pos, n_requested: int, approximate_height: float,
                        cfg, out, dispatch):
        """Same-frame adaptive-capacity overflow guard: when a tile-count
        spike is suspected, read the frame's overflow counter (a sync) and
        dispatch the SAME frame again at the next capacity rung until clean
        (the packed uniforms are on the device already). Returns (the config
        the frame ended on, its output)."""
        ad = self._adaptive.get(view_id)
        if ad is None or not self._spike_suspected(view_id, pos, n_requested,
                                                   approximate_height):
            return cfg, out
        ladder = ad["ladder"]
        while cfg.tile_capacity < ladder[-1]:
            self.overflow_checks += 1
            if out.overflow == 0:
                break
            nxt = next(c for c in ladder if c > cfg.tile_capacity)
            cfg = dataclasses.replace(self._static_cfgs[view_id], tile_capacity=nxt)
            ad["capacity"] = nxt
            self.overflow_redispatches += 1
            out = dispatch(cfg)
        return cfg, out

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
        spherical-with-Taylor frames at grid size 16 with ``pallas_sampling``
        on (its blend is always per vertex); every other view configuration
        takes the staged path. The JAX package's ``Terrain._use_fused``."""
        return (cfg.pallas_sampling and cfg.grid_size == 16
                and cfg.spherical == cfg.high_precision)

    @staticmethod
    def frame_step(block_array: torch.Tensor, uniform_blob: torch.Tensor,
                   cfg: StaticTerrainConfig, plan, max_value: float, albedo_blocks=None,
                   albedo_channels: int = 0, albedo_bits: int = 0, shade_spec=None,
                   tiles=None):
        """unpack -> refine -> the mesh: patch plan + fused mesh kernel (with
        the albedo and its shade fused in when given;
        meshgen.fused_kernel_args) where :meth:`use_fused` holds, else
        meshgen.generate_mesh_grid. With ``tiles`` (a frozen frame, debug
        freeze) the GIVEN tile list is meshed from the new camera instead
        of a refined one.

        Returns (sorted tiles, the fused kernel's raw mesh or the staged
        path's GridMeshOutput, mesh kernel inputs (fused only), uniforms)."""
        uniforms = unpack_frame_uniforms(
            uniform_blob, cfg.side_count, cfg.lod_count, cfg.tree_size
        )
        if tiles is None:
            with tracing.span("stage::refine"):
                tiles = refinement.refine_tiles(uniforms, cfg)
        with tracing.span("stage::mesh"):
            if not Terrain.use_fused(cfg):
                mesh, tiles = meshgen.generate_mesh_grid(tiles, block_array, uniforms, cfg,
                                                         plan, max_value)
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
        with tracing.span("stage::refine"):
            tiles = refinement.refine_tiles(uniforms, cfg)
        with tracing.span("stage::mesh"):
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

        Opens the frame's tracing record (``utils/tracing.py``).
        """
        with tracing.span("terrain::update", frame=self.frame_index, device=self.device):
            blobs, req_counts, heights = self._host_stage(view_positions, view_projections,
                                                          to_device=True)
            return self._device_views(view_positions, blobs, req_counts, heights)

    def _host_stage(self, view_positions: dict, view_projections: dict | None = None,
                    to_device: bool = False):
        """Steps 1-4 of a frame on the host: the request scans, residency and
        IO, then per view the entries, the height probe, the approximation
        and the packed uniforms. Returns (the blobs in view order, on the
        device with ``to_device``, each view's request count, each view's
        approximate height), what the device stage's guards read."""
        view_projections = view_projections or {}
        # 1. request scans (TileTree::compute_requests, plugin.rs:47)
        with tracing.span("update::requests"):
            released, requested = [], []
            req_counts = {}
            for view_id, pos in view_positions.items():
                tree = self.tile_trees[view_id]
                tree.compute_requests(pos)
                released.extend(tree.released_tiles)
                requested.extend(tree.requested_tiles)
                req_counts[view_id] = len(tree.requested_tiles)
            tracing.count("tiles_requested", len(requested))

        # 2. atlas residency + IO (TileAtlas::update, plugin.rs:49)
        with tracing.span("update::residency"):
            self.atlas.update(released, requested)
            self._flush_uploads()

        # 3.-4. per view: adjust entries, height probe, approximation, the
        # packed uniforms (plugin.rs:50-55)
        with tracing.span("update::uniforms"):
            blobs, heights = [], {}
            for view_id, pos in view_positions.items():
                tree = self.tile_trees[view_id]
                tree.adjust_to_tile_atlas(self.atlas)
                tree.update_approximate_height(self.atlas)
                heights[view_id] = float(tree.approximate_height)
                approx = TerrainModelApproximation.compute(
                    self.config.model, pos, tree.origin_lod, tree.approximate_height
                )
                blobs.append(pack_frame_uniforms(
                    self.config.model, pos, approx, tree.origins, tree.entries,
                    tree.view_tile_int, tree.view_tile_frac,
                    self.view_configs[view_id],
                    view_proj=view_projections.get(view_id),
                ))
            if to_device:
                tracing.count("upload_bytes", sum(b.nbytes for b in blobs))
                blobs = self._blobs_to_device(blobs)
        return blobs, req_counts, heights

    def _flush_uploads(self) -> None:
        """Step 2's uploads of the newly loaded tiles into the device stores."""
        self.atlas.flush_uploads()

    def _device_views(self, view_positions: dict, blobs_dev: list, req_counts: dict,
                      heights: dict) -> dict[object, TerrainFrameOutput]:
        """Step 5 (render schedule): per view, its device stage on its blob,
        with the adaptive-capacity rung, the overflow guard (which reads the
        view's request count and approximate height) and freeze."""
        outputs = {}
        for (view_id, pos), blob_dev in zip(view_positions.items(), blobs_dev):
            self._last_blobs[view_id] = blob_dev
            freezing = self.debug is not None and self.debug.freeze
            frozen = self._frozen_tiles.get(view_id) if freezing and self.use_grid_mesh else None
            cfg = self._adapted_cfg(view_id, frozen is not None)

            def dispatch(cfg_x, blob_dev=blob_dev, frozen=frozen):
                return self._device_stage(blob_dev, cfg_x, frozen)

            out = dispatch(cfg)
            if frozen is None:
                cfg, out = self._overflow_guard(view_id, pos, req_counts[view_id],
                                                heights[view_id], cfg, out, dispatch)
                if freezing and self.use_grid_mesh:
                    self._frozen_tiles[view_id] = out.tiles
            self._read_count_async(view_id, out.tiles)
            self._last_frame_cfgs[view_id] = cfg
            outputs[view_id] = out
        self.frame_index += 1
        return outputs

    def _blobs_to_device(self, blobs: list) -> list:
        """The views' packed uniforms on the device: ONE copy per view."""
        return [interop.blob_to_device(b, self.device) for b in blobs]

    def height_blocks(self) -> torch.Tensor:
        """The height attachment's (N, 32, 128) block store that the device
        stage reads."""
        return self.atlas.attachments[0].block_array

    def _device_stage(self, blob_dev: torch.Tensor, cfg: StaticTerrainConfig,
                      frozen=None) -> TerrainFrameOutput:
        """One view's device stage at ``cfg`` (the view's config, or an
        adaptive-capacity rung of it): the mesh by the terrain's path, then
        the material stage. ``frozen``: the pinned tile list of a freeze
        frame, meshed without the in-kernel material (as the JAX pipeline's
        frozen step)."""
        height = self.atlas.attachments[0]
        if not self.use_grid_mesh:
            tiles, mesh = self.frame_step_vertex(
                height.slabs[0], blob_dev, cfg, height.config.scale, height.config.offset)
            return TerrainFrameOutput(tiles, None, cfg, mesh=mesh)
        fused = None
        if self.use_fused(cfg) and not cfg.spherical and frozen is None:
            fused = self._fused_material
        albedo = {}
        if fused is not None:
            albedo = dict(albedo_blocks=self.atlas.attachments[fused.index].block_array,
                          albedo_channels=fused.channels, albedo_bits=fused.bits,
                          shade_spec=fused.shade)
        tiles, product, args, uniforms = self.frame_step(
            self.height_blocks(), blob_dev, cfg, height.patch_plan,
            height.config.format.max_value, tiles=frozen, **albedo,
        )
        # the fused step hands over the kernel's raw tensor (its grid view
        # is made on first access), the staged step a ready mesh
        raw = product if isinstance(product, torch.Tensor) else None
        colors = None
        if fused is None and self._shade_opts is not None:
            with tracing.span("stage::material"):
                mesh = product if raw is None else meshgen.fused_to_grid(raw, tiles, cfg)
                colors = self._maybe_shade(mesh, tiles, uniforms, cfg)
        return TerrainFrameOutput(
            tiles, raw, cfg, args, colors, fused.channels if fused else 0,
            mesh=product if raw is None else None)

    def last_uniform_blob(self, view_id) -> np.ndarray:
        """The packed uniform blob of the view's last frame, on the host."""
        return self._last_blobs[view_id].cpu().numpy()

    def render_image(self, view_id, out: TerrainFrameOutput, view_proj, width: int, height: int,
                     pixel_texturing=None, **kw):
        """Rasterize a frame output to an (H, W, 4) image on the terrain's
        device: the per-pixel fragment stage (render/raster.py) wired from
        this terrain's state, the view's last uniforms and config, the
        current material and debug view, and (optionally) per-pixel deferred
        texturing. ``view_proj``: (4, 4) numpy or tensor. Grid meshes only
        (the fused and the staged path).

        ``pixel_texturing``: attachment index to sample per pixel with
        analytic screen-derivative mip selection (the reference's
        textureSampleGrad path, fragment.wgsl:35-49). Defaults to the
        material's albedo attachment when the current shading samples
        exactly that one; ``False`` interpolates vertex colours instead.
        Attachments a vertex-rate material needs (the vertex shade mode,
        debug views, no per-pixel texturing) are sampled at the mesh's
        vertices by :meth:`sample_attachment_grid`.

        Returns ``(image, RasterOutput)``.
        """
        from bevy_terrain_tpu_torch.render import raster

        with tracing.span("terrain::render", frame=tracing.LAST):
            raster._grid_mesh(out.mesh)
            uniforms, cfg = self.frame_inputs(view_id)
            material = self.shading_fn
            lighting, debug_view = True, None
            if self._shade_opts is not None:
                lighting, debug_view = self._shade_opts[0], self._shade_opts[1]
            needs = getattr(getattr(material, "base_color", None), "attachment_index", None)
            if pixel_texturing is None and needs is not None and self._shade_opts is not None \
                    and self._shade_opts[4] == (needs,):
                pixel_texturing = needs
            if pixel_texturing not in (None, False):
                att = self.atlas.attachments[pixel_texturing]
                kw.setdefault("pixel_attachment", (
                    tuple(att.slabs), att.config.scale, att.config.offset,
                    att.config.format.max_value, att.config.texture_size))
            kw.setdefault("material", material)
            kw.setdefault("lighting", lighting)
            kw.setdefault("debug_view", debug_view)
            vertex_path = (kw["debug_view"] is not None or kw.get("shade_mode", "pixel") == "vertex"
                           or "pixel_attachment" not in kw)
            if needs is not None and vertex_path and "attachment_samples" not in kw:
                kw["attachment_samples"] = {
                    needs: self.sample_attachment_grid(view_id, out, attachment_index=needs)}
            return raster.render_view(out.mesh, out.tiles, uniforms, cfg, view_proj, width, height,
                                      **kw)

    def frame_inputs(self, view_id):
        """(FrameUniforms, StaticTerrainConfig) of the view's last frame:
        what a consumer outside the pipeline needs beside the frame output
        (a rasterizer, custom shading, debug tooling). The uniforms are
        views of the last blob on the terrain's device; the config is the
        one the frame ran with (adaptive-capacity rungs included), so its
        ``tile_capacity`` is the output tensors' leading size. Call after
        :meth:`update`."""
        cfg = self._last_frame_cfgs[view_id]
        return unpack_frame_uniforms(self._last_blobs[view_id], cfg.side_count, cfg.lod_count,
                                     cfg.tree_size), cfg

    def _query_points(self, positions) -> torch.Tensor:
        """World positions (N, 3), numpy or tensor, as f32 on the terrain's
        device."""
        if not isinstance(positions, torch.Tensor):
            positions = torch.from_numpy(np.asarray(positions, np.float32))
        pts = positions.to(device=self.device, dtype=torch.float32)
        if pts.dim() != 2 or pts.shape[1] != 3:
            raise ValueError(f"positions must be (N, 3), got {tuple(pts.shape)}")
        return pts

    def query_heights(self, view_id, positions) -> torch.Tensor:
        """Batched terrain height queries on the terrain's device
        (collision, physics, placement): the host sampling API's chain over
        (N, 3) world positions (ops/sampling.query_heights), against the
        view's last-frame uniforms, which stay on the device. Call after
        :meth:`update`. Returns (N,) f32 heights on the terrain's device."""
        height = self.atlas.attachments[0]
        uniforms, _ = self.frame_inputs(view_id)
        return sampling.query_heights(
            height.slabs[0], uniforms, self._static_cfgs[view_id],
            self._query_points(positions), height.config.scale, height.config.offset)

    def query_attachment(self, view_id, positions, attachment_index: int) -> torch.Tensor:
        """Batched attachment queries at (N, 3) world positions on the
        terrain's device (ops/sampling.query_attachment, the host
        ``sample_attachment`` chain). Returns (N, C) values in [0, 1]."""
        att = self.atlas.attachments[attachment_index]
        uniforms, _ = self.frame_inputs(view_id)
        return sampling.query_attachment(
            att.slabs[0], uniforms, self._static_cfgs[view_id], self._query_points(positions),
            att.config.scale, att.config.offset, att.config.format.max_value)

    def sample_attachment_grid(self, view_id, frame_output: TerrainFrameOutput,
                               attachment_index: int, grad_taps: int = 1) -> torch.Tensor:
        """Sample an attachment (albedo, splat, ...) at the frame's morphed
        vertex uvs, the fragment-stage attachment fetch for custom materials
        (attachments.wgsl:12-43), with the view's last uniforms. Returns
        (F, G+1, G+1, C) f32 in [0, 1]. ``grad_taps > 1`` takes the
        anisotropic multi-tap sampler, the SAMPLE_GRAD equivalent for colour
        under grazing angles (``grad_taps`` staged sampler passes,
        ops/patch_sampling.sample_attachment_vertices_grad)."""
        if not self.use_grid_mesh:
            raise RuntimeError("sample_attachment_grid requires the grid mesh path")
        att = self.atlas.attachments[attachment_index]
        if att.block_array is None:
            raise NotImplementedError(
                f"attachment {attachment_index} ({att.name!r}) is too small for the patch "
                f"plan and cannot be sampled at the mesh's vertices")
        uniforms, cfg = self.frame_inputs(view_id)
        if grad_taps > 1:
            mesh = frame_output.mesh
            return sample_attachment_vertices_grad(
                att.block_arrays, frame_output.tiles, mesh.uvs, mesh, uniforms, cfg,
                att.patch_plan, att.config.format.max_value, taps=grad_taps,
                packed_channels=att.config.format.channels if att.block_packed else 0,
                packed_bits=att.packed_bits)
        return self._sample(attachment_index, frame_output.tiles, frame_output.mesh, uniforms,
                            cfg)
