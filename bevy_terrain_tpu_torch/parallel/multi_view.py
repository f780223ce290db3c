"""Several distinct views over one shared atlas: on one card, or one view
per card over a process group.

Torch twin of the JAX package's ``parallel/multi_view.py``. Each view (a
camera, a shadow-casting light, one half of a split screen, ...) is
independent given the shared atlas (the reference's multi-view sharing,
terrain_view.rs:6-7). The JAX package shards the views axis over a device
mesh with ``shard_map``, one view per device, each device running the
single-view program. The port has two forms:

* **one card** (no ``group``): the views are stepped one after another on
  it, each by the single-view device step, and their products are stacked
  along a leading views axis, the shape the JAX step returns;
* **a process group** (``group``: one process per card, parallel/launch.py;
  NCCL on the cards, gloo on the CPU): rank r steps view r on its card.
  Rank 0 is the JAX single controller's host: it runs every view's request
  scan against the one atlas, the residency and the IO, and packs every
  view's uniforms; it broadcasts the frame's uploads and the (V, L) blob
  stack, and every rank writes the uploads into its own block store (the
  whole store, replicated, or its slot-major shard). A sharded store is
  read through :func:`~bevy_terrain_tpu_torch.parallel.sharded_atlas.
  fetch_view_patches`: one all-gather and one reduce-scatter a frame.

A ``devices`` list that names more than one distinct device without a
group raises ``ValueError``: start one process per card with
:func:`~bevy_terrain_tpu_torch.parallel.launch.launch`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops.meshgen import GridMeshOutput
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, unpack_frame_uniforms
from bevy_terrain_tpu_torch.ops.refinement import RefinementOutput
from bevy_terrain_tpu_torch.parallel.collective_audit import profile_collectives
from bevy_terrain_tpu_torch.parallel.sharded_atlas import (
    fetch_patches_sharded, fetch_view_patches, shard_blocks, shard_range,
)
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas, apply_block_uploads


def _one_device(devices) -> torch.device:
    """The one device that ``devices`` names; raises ValueError for two or
    more distinct devices, which need one process each."""
    named = [torch.device(d) for d in devices]
    if not named:
        raise ValueError("no device given")
    distinct = {(d.type, d.index or 0) for d in named}
    if len(distinct) > 1:
        raise ValueError(
            f"{sorted(distinct)} name {len(distinct)} devices: one process steps one device; "
            "start one process per card with bevy_terrain_tpu_torch.parallel.launch.launch "
            "and pass its process group as group=")
    return named[0]


def _rank_device(devices, group) -> torch.device:
    """This rank's device: ``devices[rank]``, one device per rank."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if len(devices) != n:
        raise ValueError(f"a group of {n} ranks needs {n} devices, got {len(devices)}")
    return torch.device(devices[rank])


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
                          attachment_offset: float = 2 / 128, audit: bool = False,
                          group=None):
    """Run one frame step for ``len(devices) * views_per_device`` views.

    ``uniforms`` is a single view's FrameUniforms broadcast to all views, OR
    a LIST of per-view FrameUniforms (distinct cameras), stacked with
    :func:`stack_uniforms`. Each view runs ``refine_tiles`` and the
    per-vertex mesh (``meshgen.generate_mesh``, no kernel) on ``slab``.

    Without ``group`` every view steps on the one device that ``devices``
    names (the slab's). With a process group, rank r steps views
    ``[r * views_per_device, (r + 1) * views_per_device)`` on
    ``devices[r]``, where its ``uniforms`` and ``slab`` lie.

    Returns (positions, heights, tile_counts) with a leading views axis (the
    rank's views in a group); with ``audit=True``, (that, the step's
    collectives, :func:`~bevy_terrain_tpu_torch.parallel.collective_audit.
    collective_stats`): ``{}``, the step exchanges nothing.
    """
    n_views = len(devices) * views_per_device
    if group is None:
        device, first, count = _one_device(devices), 0, n_views
    else:
        device = _rank_device(devices, group)
        first, count = dist.get_rank(group) * views_per_device, views_per_device
    if isinstance(uniforms, (list, tuple)):
        if len(uniforms) != n_views:
            raise ValueError(f"{len(uniforms)} uniforms for {n_views} views")
        stacked = stack_uniforms(list(uniforms))
    else:
        stacked = _tree_map(lambda x: x.expand((n_views,) + x.shape), uniforms)

    def step():
        out = []
        for i in range(first, first + count):
            u = _tree_map(lambda x: x[i], stacked)
            tiles = refinement.refine_tiles(u, cfg)
            mesh = meshgen.generate_mesh(tiles, slab, u, cfg, attachment_scale,
                                         attachment_offset)
            out.append((mesh.positions, mesh.heights, tiles.tile_count))
        return tuple(torch.stack(x) for x in zip(*out))

    if audit:
        out, stats, _ = profile_collectives(step, device=device)
        return out, stats
    return step()


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


def _stack(frames: list) -> dict:
    return {"tiles": _tree_map(lambda *xs: torch.stack(xs), *(f.tiles for f in frames)),
            "mesh": _tree_map(lambda *xs: torch.stack(xs), *(f.mesh for f in frames))}


class _ViewsTerrain(Terrain):
    """The Terrain that steps a MultiViewTerrain's views: their blobs go to
    the device in one (V, L) copy a frame, and a view's mesh is the fused
    kernel only where :meth:`Terrain.use_fused` (which reads
    ``pallas_sampling``) holds, else ``meshgen.generate_mesh_grid`` over the
    block store or its shards.

    In a process group its atlas is a shape-only shell on the meta device:
    rank 0 drives its residency and IO (the host flow), and the frame's
    uploads go, through :meth:`_flush_uploads` and the broadcasts of
    :meth:`MultiViewTerrain.update`, into each rank's ``store``: the whole
    (N, 32, 128) block array, or its shard of ``shard_range`` rows."""

    def __init__(self, config, device, n_shards: int, group=None):
        super().__init__(config, device if group is None else "meta")
        self.device = torch.device(device)
        self.group = group
        self.n_shards = n_shards  # 0: the store is read whole (replicated)
        self.last_stacked = None  # the last frame's (V, L) int32 blobs on the device
        self._shards = (None, -1)  # (shards, the frame they were cut in)
        self.uploads = None  # rank 0 of a group: the frame's (slots, quads)
        self.store, self.first_block = None, None
        if group is not None and self.use_grid_mesh:
            n_blocks = int(self.atlas.attachments[0].block_array.shape[0])
            rows = n_blocks
            if n_shards:
                self.first_block, rows = shard_range(n_blocks, n_shards, dist.get_rank(group))
            self.store = torch.zeros((rows, 32, 128), dtype=torch.int32, device=self.device)

    def enable_adaptive_capacity(self, view_id, ladder=None, headroom: float = 2.0) -> None:
        if self.group is not None and self.n_shards:
            raise NotImplementedError(
                "the sharded exchange needs one tile capacity on every rank; adaptive "
                "capacity would give each rank its own")
        super().enable_adaptive_capacity(view_id, ladder, headroom)

    def height_blocks(self) -> torch.Tensor:
        """In a group, this rank's store (whole, or its shard); else the
        atlas's own array (updated in place by the uploads, never copied)."""
        return super().height_blocks() if self.group is None else self.store

    def blocks(self) -> torch.Tensor:
        """The block store as the staged step reads it: the height blocks,
        or on one card with ``shard_atlas`` their shards, cut once a frame
        (a padded copy goes stale with the next upload)."""
        if self.group is not None or not self.n_shards:
            return self.height_blocks()
        if self._shards[1] != self.frame_index:
            self._shards = (shard_blocks(self.n_shards, self.height_blocks()), self.frame_index)
        return self._shards[0]

    def _flush_uploads(self) -> None:
        if self.group is None:
            super()._flush_uploads()
        else:  # rank 0: the uploads go to every rank's store (MultiViewTerrain.update)
            self.uploads = self.atlas.attachments[0].take_block_uploads()

    def _blobs_to_device(self, blobs: list) -> list:
        # ONE copy per frame; each view reads a contiguous int32 row
        self.last_stacked = interop.blob_to_device(np.stack(blobs), self.device)
        return list(self.last_stacked)

    def _device_stage(self, blob_dev: torch.Tensor, cfg: StaticTerrainConfig,
                      frozen=None) -> TerrainFrameOutput:
        if self.use_fused(cfg):
            return super()._device_stage(blob_dev, cfg, frozen)
        height = self.atlas.attachments[0]
        u = unpack_frame_uniforms(blob_dev, cfg.side_count, cfg.lod_count, cfg.tree_size)
        tiles = frozen if frozen is not None else refinement.refine_tiles(u, cfg)
        fetch_fn = None
        if self.n_shards:
            fetch_fn = (fetch_patches_sharded if self.group is None
                        else functools.partial(fetch_view_patches, group=self.group))
        mesh, tiles = meshgen.generate_mesh_grid(
            tiles, self.blocks(), u, cfg, height.patch_plan, height.config.format.max_value,
            fetch_fn=fetch_fn, n_blocks=int(height.block_array.shape[0]))
        return TerrainFrameOutput(tiles, None, cfg, mesh=mesh)


class MultiViewTerrain:
    """N DISTINCT views sharing one TileAtlas (the reference's multi-view
    sharing, terrain_view.rs:6-7: N TileTrees, one atlas).

    The views are the views of one :class:`Terrain` (``self.terrain``), so
    the host flow is ``Terrain.update``'s: every view runs its own request
    scan against the SHARED atlas (request-counted residency), and then its
    device step. Two things differ: the views' uniform blobs go to the card
    in one (V, L) copy a frame, and a view's device step picks its path the
    JAX package's way. The block store is read in place (replicated) or,
    with ``shard_atlas``, cut into one slot-major shard per view.

    Without ``group`` (one card): ``devices`` (one per view; default the
    card, ``[cuda] * len(view_ids)``) must name one device; the replicated
    store is the atlas's own block array, the shards are views of it, and
    the fetch sums over them there.

    With ``group`` (an initialized process group of ``len(view_ids)``
    ranks, one view per rank as JAX puts one view per device; see
    parallel/launch.py): every rank calls every method, with the same
    arguments. Rank r steps ``view_ids[r]`` on ``devices[r]`` (default
    ``[cuda:0, cuda:1, ...]``). Rank 0 runs the host flow and broadcasts
    each frame's uploads and blobs (:meth:`update`); only the height
    attachment's block store travels, as the JAX class reads only
    ``attachments[0]``. ``update`` returns the rank's own view;
    :meth:`gather_frames` brings every view's to rank 0.

    ``pallas_sampling`` (a static override; default on the card, without
    ``shard_atlas``, at grid size 16) picks the path by the rule of every
    ``Terrain``, :meth:`Terrain.use_fused`: the fused mesh kernel where it
    holds, otherwise ``meshgen.generate_mesh_grid`` (with K6 only for the
    switch on and the store read whole). ``interpret=True`` (the JAX class runs
    its kernel under the Pallas interpreter) asks for the plain versions,
    which run on the CPU: on a CUDA device it raises.
    """

    def __init__(self, config, view_ids, devices=None, view_config=None,
                 queue_capacity: int = 8192, shard_atlas: bool = False, interpret: bool = False,
                 group=None, **static_overrides):
        if group is not None and len(config.attachments) > 1:
            raise NotImplementedError(
                "the multi-card step carries only the height attachment's block store, as "
                "the JAX MultiViewTerrain reads only attachments[0]; a material's "
                "attachments would need stores of their own on every card")
        if group is not None and shard_atlas and static_overrides.get("pallas_sampling"):
            raise ValueError("the fused mesh kernel reads the whole block store; with "
                             "shard_atlas a rank holds only its shard")
        self.view_ids = list(view_ids)
        self.group = group
        if group is not None and dist.get_world_size(group) != len(self.view_ids):
            raise ValueError(f"{len(self.view_ids)} views need a group of {len(self.view_ids)} "
                             f"ranks (one view per rank), got {dist.get_world_size(group)}")
        if devices is None:
            devices = ([torch.device("cuda", r) for r in range(len(self.view_ids))]
                       if group is not None else [torch.device("cuda")] * len(self.view_ids))
        devices = list(devices)
        if len(devices) != len(self.view_ids):
            raise ValueError(
                f"{len(self.view_ids)} views need {len(self.view_ids)} devices, got "
                f"{len(devices)} (one view per device slot)")
        self.device = _one_device(devices) if group is None else _rank_device(devices, group)
        if interpret and self.device.type == "cuda":
            raise ValueError("interpret=True runs the kernels' plain versions, on the CPU; "
                             f"the views step on {self.device}")
        self.config = config
        self.view_config = view_config or TerrainViewConfig()
        self.shard_atlas = shard_atlas
        self.terrain = _ViewsTerrain(config, self.device,
                                     len(self.view_ids) if shard_atlas else 0, group)
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
        # the last frame's host broadcasts (a group): {"collective-broadcast":
        # {"count", "bytes"}}, counted as they are made
        self.host_stats: dict = {}

    @property
    def atlas(self) -> TileAtlas:
        return self.terrain.atlas

    @property
    def tile_trees(self) -> dict:
        return self.terrain.tile_trees

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def streaming(self) -> bool:
        """Whether a tile is still queued or loading (in a group, rank 0's
        answer, broadcast: every rank gets the same)."""
        busy = bool(self.atlas.state.to_load) or any(a.loading for a in self.atlas.attachments)
        if self.group is None:
            return busy
        flag = torch.tensor([int(busy)], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())

    def update(self, view_positions: dict) -> dict:
        """One frame for every view: ``{view_id: MultiViewFrameOutput}``, in
        a group for the rank's own view."""
        positions = {v: view_positions[v] for v in self.view_ids}
        if self.group is None:
            frames = self.terrain.update(positions)
            out = _stack([frames[v] for v in self.view_ids])
            return {v: MultiViewFrameOutput(out, i) for i, v in enumerate(self.view_ids)}
        t, rank, n = self.terrain, self.rank, len(self.view_ids)
        self.host_stats = {}

        def broadcast(x):
            dist.broadcast(x, 0, group=self.group)
            s = self.host_stats.setdefault("collective-broadcast", {"count": 0, "bytes": 0})
            s["count"] += 1
            s["bytes"] += x.numel() * x.element_size()
            return x

        # the header: uploaded slots k, blob length L, each view's request
        # count and approximate height (the owner's overflow guard reads both)
        if rank == 0:
            blobs, req, heights = t._host_stage(positions)
            slots, quads = t.uploads
            header = torch.tensor([len(slots), blobs[0].size,
                                   *(req[v] for v in self.view_ids),
                                   *(heights[v] for v in self.view_ids)], dtype=torch.float64)
            header = broadcast(header.to(self.device))
        else:
            header = broadcast(torch.empty(2 + 2 * n, dtype=torch.float64, device=self.device))
        head = header.tolist()
        k, length = int(head[0]), int(head[1])
        per_slot = self.atlas.attachments[0].patch_plan.total_blocks_per_slot
        if k:
            if rank == 0:
                slots_t = torch.from_numpy(slots).to(self.device)
                quads_t = torch.from_numpy(quads).to(self.device)
            else:
                slots_t = torch.empty(k, dtype=torch.int64, device=self.device)
                quads_t = torch.empty((k * per_slot, 32, 128), dtype=torch.int32,
                                      device=self.device)
            apply_block_uploads(t.store, broadcast(slots_t), broadcast(quads_t), per_slot,
                                t.first_block)
        if rank == 0:
            stacked = torch.from_numpy(np.stack(blobs).astype(np.int32)).to(self.device)
        else:
            stacked = torch.empty((n, length), dtype=torch.int32, device=self.device)
        t.last_stacked = broadcast(stacked)
        v = self.view_ids[rank]
        frames = t._device_views({v: positions[v]}, [t.last_stacked[rank]],
                                 {v: int(head[2 + rank])}, {v: head[2 + n + rank]})
        return {v: MultiViewFrameOutput(_stack([frames[v]]), 0)}

    def _step_last(self) -> None:
        """Each of this process's views' device stage on its last blob."""
        for v in (self.view_ids if self.group is None else [self.view_ids[self.rank]]):
            self.terrain._device_stage(self.terrain._last_blobs[v],
                                       self.terrain._last_frame_cfgs[v])

    def audit_step(self) -> dict:
        """Collective op count and per-rank output bytes of the last frame's
        device step, read from a profiler trace of it run again
        (parallel/collective_audit.py; the twin of the JAX audit of the
        compiled step). Call after one update(); in a group every rank calls
        it. Replicated-atlas mode must report {}: the step exchanges
        nothing; sharded-atlas mode reports its all-gather and
        reduce-scatter. The frame's host broadcasts are apart, in
        :attr:`host_stats`. On the card, the NCCL kernels of the trace are
        in :attr:`nccl_kernels`."""
        _, stats, self.nccl_kernels = profile_collectives(self._step_last, device=self.device)
        return stats

    def gather_frames(self, frames: dict) -> dict | None:
        """Every view's frame on rank 0: ``frames`` is this rank's
        :meth:`update` result; rank 0 gets ``{view_id: MultiViewFrameOutput}``
        for all views (on its device), the other ranks None. A collective of
        its own (one gather per tensor), outside the frame step."""
        if self.group is None:
            return frames
        mine = frames[self.view_ids[self.rank]]._s
        n = len(self.view_ids)

        def gather(x):
            x = x.contiguous()
            wire = x.view(torch.uint8) if x.dtype == torch.bool else x
            parts = [torch.empty_like(wire) for _ in range(n)] if self.rank == 0 else None
            dist.gather(wire, parts, dst=0, group=self.group)
            if parts is None:
                return None
            out = torch.cat(parts)
            return out.view(torch.bool) if x.dtype == torch.bool else out

        stacked = {k: _tree_map(gather, mine[k]) for k in ("tiles", "mesh")}
        if self.rank:
            return None
        return {v: MultiViewFrameOutput(stacked, i) for i, v in enumerate(self.view_ids)}
