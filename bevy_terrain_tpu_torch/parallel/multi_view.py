"""Several distinct views over one shared atlas, stepped on one card.

Torch twin of the JAX package's ``parallel/multi_view.py``. Each view (a
camera, a shadow-casting light, one half of a split screen, ...) is
independent given the shared atlas (the reference's multi-view sharing,
terrain_view.rs:6-7). The JAX package shards the views axis over a device
mesh with ``shard_map``, one view per device, each device running the
single-view program. The port has one card: the views are stepped one
after another on it, each by the single-view device step, and their
products are stacked along a leading views axis, the shape the JAX step
returns.

A ``devices`` list that names more than one distinct device raises
``NotImplementedError``: stepping views across cards is not implemented.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops.meshgen import GridMeshOutput
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, unpack_frame_uniforms
from bevy_terrain_tpu_torch.ops.refinement import RefinementOutput
from bevy_terrain_tpu_torch.parallel.sharded_atlas import fetch_patches_sharded, shard_blocks
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas


def _one_device(devices) -> torch.device:
    """The one device that ``devices`` names; raises NotImplementedError
    for two or more distinct devices."""
    named = [torch.device(d) for d in devices]
    if not named:
        raise ValueError("no device given")
    distinct = {(d.type, d.index or 0) for d in named}
    if len(distinct) > 1:
        raise NotImplementedError(
            f"the views step on one device; {sorted(distinct)} name {len(distinct)} devices")
    return named[0]


def _tree_map(fn, *trees):
    """``fn`` over the tensors of equal dataclass trees (FrameUniforms,
    RefinementOutput, GridMeshOutput), field by field."""
    if dataclasses.is_dataclass(trees[0]):
        return type(trees[0])(**{
            f.name: _tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(trees[0])})
    return fn(*trees)


def stack_uniforms(uniform_list):
    """Stack per-view FrameUniforms along a leading views axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *uniform_list)


def multi_view_frame_step(devices, cfg: StaticTerrainConfig, uniforms, slab,
                          views_per_device: int = 1, attachment_scale: float = 124 / 128,
                          attachment_offset: float = 2 / 128):
    """Run one frame step for ``len(devices) * views_per_device`` views on
    the one device that ``devices`` names (the slab's).

    ``uniforms`` is a single view's FrameUniforms broadcast to all views, OR
    a LIST of per-view FrameUniforms (distinct cameras), stacked with
    :func:`stack_uniforms`. Each view runs ``refine_tiles`` and the
    per-vertex mesh (``meshgen.generate_mesh``, no kernel) on ``slab``.

    Returns (positions, heights, tile_counts) with a leading views axis.
    """
    _one_device(devices)
    n_views = len(devices) * views_per_device
    if isinstance(uniforms, (list, tuple)):
        if len(uniforms) != n_views:
            raise ValueError(f"{len(uniforms)} uniforms for {n_views} views")
        stacked = stack_uniforms(list(uniforms))
    else:
        stacked = _tree_map(lambda x: x.expand((n_views,) + x.shape), uniforms)
    out = []
    for i in range(n_views):
        u = _tree_map(lambda x: x[i], stacked)
        tiles = refinement.refine_tiles(u, cfg)
        mesh = meshgen.generate_mesh(tiles, slab, u, cfg, attachment_scale, attachment_offset)
        out.append((mesh.positions, mesh.heights, tiles.tile_count))
    return tuple(torch.stack(x) for x in zip(*out))


class MultiViewFrameOutput:
    """One view's slice of the stacked multi-view frame products: the dict
    ``{"tiles": RefinementOutput, "mesh": GridMeshOutput}`` whose tensors
    carry a leading views axis."""

    def __init__(self, stacked: dict, index: int):
        self._s = stacked
        self._i = index

    @property
    def tiles(self) -> RefinementOutput:
        return _tree_map(lambda x: x[self._i], self._s["tiles"])

    @property
    def mesh(self) -> GridMeshOutput:
        return _tree_map(lambda x: x[self._i], self._s["mesh"])

    @property
    def tile_count(self) -> int:
        """The view's tile count (reads the device: one sync)."""
        return int(self._s["tiles"].tile_count[self._i])


class _ViewsTerrain(Terrain):
    """The Terrain that steps a MultiViewTerrain's views: their blobs go to
    the device in one (V, L) copy a frame, and a view's mesh is the fused
    kernel only where ``pallas_sampling`` selects it, else
    ``meshgen.generate_mesh_grid`` over the block store or its shards."""

    def __init__(self, config, device, n_shards: int):
        super().__init__(config, device)
        self.n_shards = n_shards  # 0: the store is read whole (replicated)
        self.last_stacked = None  # the last frame's (V, L) int32 blobs on the device
        self._shards = (None, -1)  # (shards, the frame they were cut in)

    def blocks(self) -> torch.Tensor:
        """The block store as the staged step reads it: the atlas's own
        array (updated in place by the uploads, never copied), or its
        shards, cut once a frame (a padded copy goes stale with the next
        upload)."""
        store = self.atlas.attachments[0].block_array
        if not self.n_shards:
            return store
        if self._shards[1] != self.frame_index:
            self._shards = (shard_blocks(self.n_shards, store), self.frame_index)
        return self._shards[0]

    def _blobs_to_device(self, blobs: list) -> list:
        # ONE copy per frame; each view reads a contiguous int32 row
        self.last_stacked = interop.blob_to_device(np.stack(blobs), self.device)
        return list(self.last_stacked)

    def _device_stage(self, blob_dev: torch.Tensor, cfg: StaticTerrainConfig,
                      frozen=None) -> TerrainFrameOutput:
        if cfg.pallas_sampling and self.use_fused(cfg):
            return super()._device_stage(blob_dev, cfg, frozen)
        height = self.atlas.attachments[0]
        u = unpack_frame_uniforms(blob_dev, cfg.side_count, cfg.lod_count, cfg.tree_size)
        tiles = frozen if frozen is not None else refinement.refine_tiles(u, cfg)
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, self.blocks(), u, cfg, height.patch_plan, height.config.format.max_value,
            fetch_fn=fetch_patches_sharded if self.n_shards else None,
            n_blocks=int(height.block_array.shape[0]))
        return TerrainFrameOutput(tiles, None, cfg, mesh=mesh)


class MultiViewTerrain:
    """N DISTINCT views sharing one TileAtlas (the reference's multi-view
    sharing, terrain_view.rs:6-7: N TileTrees, one atlas).

    The views are the views of one :class:`Terrain` (``self.terrain``), so
    the host flow is ``Terrain.update``'s: every view runs its own request
    scan against the SHARED atlas (request-counted residency), and then its
    device step. Two things differ: the views' uniform blobs go to the card
    in one (V, L) copy a frame, and a view's device step picks its path the
    JAX package's way. The block store is read in place (replicated: the
    atlas's own block array, no second copy) or, with ``shard_atlas``, cut
    into one slot-major shard per view and fetched through
    :func:`~bevy_terrain_tpu_torch.parallel.sharded_atlas.fetch_patches_sharded`.

    ``devices`` (one per view; default the card, ``[cuda] * len(view_ids)``)
    must name one device. ``pallas_sampling`` (a static override; default
    on the card, without ``shard_atlas``, at grid size 16) selects the
    fused mesh kernel where ``Terrain.use_fused`` holds; otherwise the step
    is ``meshgen.generate_mesh_grid``.
    """

    def __init__(self, config, view_ids, devices=None, view_config=None,
                 queue_capacity: int = 8192, shard_atlas: bool = False, **static_overrides):
        if devices is None:
            devices = [torch.device("cuda")] * len(view_ids)
        devices = list(devices)
        if len(devices) != len(view_ids):
            raise ValueError(
                f"{len(view_ids)} views need {len(view_ids)} devices, got {len(devices)} "
                "(one view per device slot)")
        self.device = _one_device(devices)
        self.config = config
        self.view_ids = list(view_ids)
        self.view_config = view_config or TerrainViewConfig()
        self.shard_atlas = shard_atlas
        self.terrain = _ViewsTerrain(config, self.device,
                                     len(self.view_ids) if shard_atlas else 0)
        if not self.terrain.use_grid_mesh:
            raise NotImplementedError(
                "the multi-view step meshes through the patch pipeline; the height "
                "attachment is too small for its plan")
        if "pallas_sampling" not in static_overrides:
            static_overrides["pallas_sampling"] = (
                self.device.type == "cuda" and not shard_atlas
                and self.view_config.grid_size == 16)
        for v in self.view_ids:
            self.terrain.add_view(v, self.view_config, queue_capacity, **static_overrides)
        self.cfg = self.terrain._static_cfgs[self.view_ids[0]]

    @property
    def atlas(self) -> TileAtlas:
        return self.terrain.atlas

    @property
    def tile_trees(self) -> dict:
        return self.terrain.tile_trees

    def update(self, view_positions: dict) -> dict:
        """One frame for every view: ``{view_id: MultiViewFrameOutput}``."""
        frames = self.terrain.update({v: view_positions[v] for v in self.view_ids})
        frames = [frames[v] for v in self.view_ids]
        out = {
            "tiles": _tree_map(lambda *xs: torch.stack(xs), *(f.tiles for f in frames)),
            "mesh": _tree_map(lambda *xs: torch.stack(xs), *(f.mesh for f in frames)),
        }
        return {v: MultiViewFrameOutput(out, i) for i, v in enumerate(self.view_ids)}
