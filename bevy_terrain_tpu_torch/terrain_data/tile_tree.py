"""The per-view TileTree: wrapping quadtree view of the terrain.

Behavioral twin of the reference ``TileTree``
(reference src/terrain_data/tile_tree.rs) with the per-slot state
held in numpy arrays and the request scan fully vectorized (the reference
iterates side x lod x tree_size^2 serially, tile_tree.rs:274-331).

Per frame:
1. :meth:`compute_requests` — update origins + per-slot coordinates, decide
   requested/released by closest-point distance (f64, exact reference
   semantics), diff against the previous state into request/release lists.
2. (TileAtlas processes the lists.)
3. :meth:`adjust_to_tile_atlas` — refresh every slot's
   (atlas_index, atlas_lod) entry with the best-loaded ancestor.
4. :meth:`approximate_height` — CPU height probe under the view.
"""

from __future__ import annotations

import numpy as np

from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math.coordinate import (
    Coordinate,
    local_position_from_side_uv,
    TileCoordinate,
)
from bevy_terrain_tpu_torch.ops.tile_tree import compute_view_anchors
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import (
    INVALID_ATLAS_INDEX,
    INVALID_LOD,
    TileAtlas,
)


class TileTree:
    """Reference tile_tree.rs:104-131 state + systems."""

    def __init__(self, tile_atlas: TileAtlas, view_config: TerrainViewConfig):
        model = tile_atlas.model
        scale = model.scale
        self.model = model
        self.view_config = view_config
        self.lod_count = tile_atlas.lod_count
        self.tree_size = view_config.tree_size
        self.geometry_tile_count = view_config.geometry_tile_count
        self.refinement_count = view_config.refinement_count
        self.grid_size = view_config.grid_size
        # distances scaled to world units (tile_tree.rs:139-153)
        self.morph_distance = view_config.morph_distance * scale
        self.blend_distance = view_config.blend_distance * scale
        self.load_distance = view_config.load_distance * scale
        self.subdivision_distance = (
            view_config.morph_distance * scale * (1.0 + view_config.subdivision_tolerance)
        )
        self.precision_threshold_distance = (
            view_config.precision_threshold_distance * scale
        )
        self.morph_range = view_config.morph_range
        self.blend_range = view_config.blend_range
        self.origin_lod = view_config.origin_lod
        self.view_world_position = np.zeros(3)
        self.approximate_height = (model.min_height + model.max_height) / 2.0

        S, L, T = model.side_count, self.lod_count, self.tree_size
        self.origins = np.zeros((S, L, 2), np.int32)
        self.view_tile_int = np.zeros((S, L, 2), np.int32)
        self.view_tile_frac = np.zeros((S, L, 2), np.float32)
        # per-slot coordinate (xy at the slot's side/lod) and request state
        self.tile_xy = np.full((S, L, T, T, 2), -1, np.int64)
        self.tile_requested = np.zeros((S, L, T, T), bool)
        # per-slot best-loaded entry (atlas_index, atlas_lod)
        self.entries = np.full((S, L, T, T, 2), -1, np.int32)
        self.requested_tiles: list[TileCoordinate] = []
        self.released_tiles: list[TileCoordinate] = []

        lods = np.arange(L)
        self._counts = (1 << lods).astype(np.float64)
        self._sides = np.broadcast_to(np.arange(S)[:, None, None, None], (S, L, T, T))
        self._lods = np.broadcast_to(lods[None, :, None, None], (S, L, T, T))

    # ------------------------------------------------------------------
    # request scan (reference tile_tree.rs:268-333, vectorized f64)
    # ------------------------------------------------------------------

    def _slot_world_positions(self, uv: np.ndarray) -> np.ndarray:
        """World positions of per-slot sample coordinates (S,L,T,T,2)->(...,3).

        f64 twin of Coordinate::world_position (coordinate.rs:110-130) over
        the whole cube at once.
        """
        model = self.model
        if model.is_spherical:
            # slots whose wrapped coordinate exceeds the per-lod tile count
            # produce uv > 1 -> NaN positions -> never requested (the
            # reference's f64 powf(0.5) of a negative does the same,
            # coordinate.rs:113); silence the benign warning
            with np.errstate(invalid="ignore"):
                local = local_position_from_side_uv(self._sides, uv)
        else:
            local = np.stack(
                [uv[..., 0] - 0.5, np.zeros_like(uv[..., 0]), uv[..., 1] - 0.5],
                axis=-1,
            )
        m = model.world_from_local
        world = local @ m[:3, :3].T + m[:3, 3]
        # normal: spherical -> local direction, planar -> +Y, mapped by the
        # inverse transpose (row-vector form: n @ M^-1 == M^-T @ n)
        local_normal = local if model.is_spherical else np.broadcast_to(
            np.array([0.0, 1.0, 0.0]), local.shape
        )
        n = local_normal @ np.linalg.inv(m[:3, :3])
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
        return world + self.approximate_height * n

    def compute_requests(self, view_world_position) -> None:
        """Reference ``compute_requests`` + ``update`` (tile_tree.rs:268-359).

        Runs the C++ scan (native/terrain_runtime.cpp::tr_scan_requests)
        unless ``BT_DISABLE_NATIVE=1`` — identical f64 math without numpy's
        per-call interpreter overhead; the vectorized numpy scan below
        remains the fallback and the fuzz oracle (test_torch_native.py).
        """
        model = self.model
        self.view_world_position = np.asarray(view_world_position, np.float64)
        S, L, T = model.side_count, self.lod_count, self.tree_size

        if self._use_native_scan():
            self._compute_anchors_native()
            self._compute_requests_native()
            return

        self.origins, self.view_tile_int, self.view_tile_frac = compute_view_anchors(
            model, self.view_world_position, L, T
        )

        # per-slot coordinates under the wrapping rule (tile_tree.rs:281-305)
        idx = np.arange(T)
        ij = np.stack(np.meshgrid(idx, idx, indexing="ij"), axis=-1)
        origin = self.origins[:, :, None, None, :].astype(np.int64)
        new_xy = origin + ((ij[None, None] - origin) % T)

        # closest-point offset (tile_tree.rs:199-214)
        view_int = self.view_tile_int[:, :, None, None, :].astype(np.int64)
        view_frac = self.view_tile_frac[:, :, None, None, :].astype(np.float64)
        tile_offset = view_int - new_xy
        offset = np.where(tile_offset < 0, 0.0, np.where(tile_offset > 0, 1.0, view_frac))

        counts = self._counts[None, :, None, None, None]
        uv = (new_xy + offset) / counts
        world = self._slot_world_positions(uv)
        distance = np.linalg.norm(world - self.view_world_position, axis=-1)
        load_distance = self.load_distance / self._counts[None, :, None, None]
        new_requested = (self._lods == 0) | (distance < load_distance)

        # diff against previous state (tile_tree.rs:307-329)
        coord_changed = np.any(new_xy != self.tile_xy, axis=-1)
        release_old = coord_changed & self.tile_requested
        release_new = ~coord_changed & self.tile_requested & ~new_requested
        request_new = new_requested & (coord_changed | ~self.tile_requested)

        self.released_tiles = self._collect(release_old, self.tile_xy) + self._collect(
            release_new, new_xy
        )
        self.requested_tiles = self._collect(request_new, new_xy)
        self.tile_xy = new_xy
        self.tile_requested = new_requested

    def _use_native_scan(self) -> bool:
        if getattr(self, "_native_scan", None) is None:
            from bevy_terrain_tpu_torch import native

            self._native_scan = native.available()
        return self._native_scan

    def _compute_anchors_native(self) -> None:
        """Per-frame view anchors via the C++ runtime (tr_project_view_uv +
        tr_view_anchors), written into the preallocated (S, L, 2) arrays.
        Ellipsoids keep the host bisection projector for the view
        coordinate; the anchor loop is still native."""
        from bevy_terrain_tpu_torch import native

        model = self.model
        if model.kind == "spherical":
            side_uv = native.project_view_uv(self.view_world_position, self._scan_lm)
        elif model.kind == "planar":
            lm = self._scan_lm
            x, y, z = self.view_world_position
            u = lm[0, 0] * x + lm[0, 1] * y + lm[0, 2] * z + lm[0, 3] + 0.5
            w = lm[2, 0] * x + lm[2, 1] * y + lm[2, 2] * z + lm[2, 3] + 0.5
            side_uv = np.array(
                [[min(max(u, 0.0), 1.0), min(max(w, 0.0), 1.0)]]
            )
        else:
            vc = Coordinate.from_world_position(self.view_world_position, model)
            side_uv = np.empty((model.side_count, 2), np.float64)
            for side in range(model.side_count):
                side_uv[side] = vc.project_to_side(side, model).uv
        native.view_anchors(
            side_uv, self.lod_count, self.tree_size,
            self.origins, self.view_tile_int, self.view_tile_frac,
        )

    @property
    def _scan_lm(self) -> np.ndarray:
        lm = getattr(self, "_scan_lm_cache", None)
        if lm is None:
            lm = np.ascontiguousarray(
                np.asarray(self.model.local_from_world, np.float64)[:3, :4]
            )
            self._scan_lm_cache = lm
        return lm

    def _compute_requests_native(self) -> None:
        from bevy_terrain_tpu_torch import native

        model = self.model
        m = getattr(self, "_scan_m_cache", None)
        if m is None:
            m = np.ascontiguousarray(
                np.asarray(model.world_from_local, np.float64)[:3, :4]
            )
            self._scan_m_cache = m
            self._scan_inv_cache = np.ascontiguousarray(np.linalg.inv(m[:3, :3]))
        inv_m3 = self._scan_inv_cache
        rel, req = native.scan_requests(
            1 if model.is_spherical else 0,
            m, inv_m3,
            np.ascontiguousarray(self.view_world_position, np.float64),
            self.approximate_height, self.load_distance,
            np.ascontiguousarray(self.origins, np.int32),
            np.ascontiguousarray(self.view_tile_int, np.int32),
            np.ascontiguousarray(self.view_tile_frac, np.float64),
            self.tile_xy, self.tile_requested,
        )
        self.released_tiles = self._from_keys(rel)
        self.requested_tiles = self._from_keys(req)

    @staticmethod
    def _from_keys(keys: np.ndarray) -> list[TileCoordinate]:
        sides = keys >> 57
        lods = (keys >> 52) & 0x1F
        xs = (keys >> 26) & 0x3FFFFFF
        ys = keys & 0x3FFFFFF
        return [
            TileCoordinate(int(s), int(l), int(x), int(y))
            for s, l, x, y in zip(sides, lods, xs, ys)
        ]

    def _collect(self, mask: np.ndarray, xy: np.ndarray) -> list[TileCoordinate]:
        sides, lods, xs, ys = (
            self._sides[mask],
            self._lods[mask],
            xy[mask][:, 0],
            xy[mask][:, 1],
        )
        return [
            TileCoordinate(int(s), int(l), int(x), int(y))
            for s, l, x, y in zip(sides, lods, xs, ys)
        ]

    # ------------------------------------------------------------------
    # atlas adjustment (reference tile_tree.rs:363-374)
    # ------------------------------------------------------------------

    def adjust_to_tile_atlas(self, tile_atlas: TileAtlas) -> None:
        index, lod = tile_atlas.state.get_best_tiles(
            self._sides, self._lods, self.tile_xy[..., 0], self.tile_xy[..., 1]
        )
        self.entries = np.stack([index, lod], axis=-1).astype(np.int32)

    # ------------------------------------------------------------------
    # CPU lookup + blend (reference tile_tree.rs:223-266)
    # ------------------------------------------------------------------

    def compute_blend(self, sample_world_position) -> tuple[int, float]:
        view_distance = float(
            np.linalg.norm(self.view_world_position - np.asarray(sample_world_position))
        )
        # Rust f64 division by zero yields inf -> clamped to the finest lod
        ratio_to_view = np.inf if view_distance == 0.0 else self.blend_distance / view_distance
        target_lod = min(np.log2(ratio_to_view), self.lod_count - 0.00001)
        lod = max(int(target_lod), 0)
        if lod == 0:
            return 0, 0.0
        ratio = float(
            np.clip((target_lod - (lod + self.blend_range)) / (lod - (lod + self.blend_range)), 0.0, 1.0)
        )
        return lod, ratio

    def lookup_tile(self, world_position, tree_lod: int):
        """Reference tile_tree.rs:239-266. Returns (atlas_index, atlas_lod,
        atlas_uv) or (INVALID, INVALID, zeros)."""
        coordinate = Coordinate.from_world_position(world_position, self.model)
        tile_count = float(1 << tree_lod)
        tree_xy = np.minimum(coordinate.uv * tile_count, tile_count - 0.000001)
        entry = self.entries[
            coordinate.side,
            tree_lod,
            int(tree_xy[0]) % self.tree_size,
            int(tree_xy[1]) % self.tree_size,
        ]
        atlas_index, atlas_lod = int(entry[0]), int(entry[1])
        if atlas_lod == INVALID_LOD:
            return INVALID_ATLAS_INDEX, INVALID_LOD, np.zeros(2)
        atlas_uv = (tree_xy / float(1 << (tree_lod - atlas_lod))) % 1.0
        return atlas_index, atlas_lod, atlas_uv

    def update_approximate_height(self, tile_atlas: TileAtlas) -> None:
        """Reference tile_tree.rs:376-386."""
        from bevy_terrain_tpu_torch.terrain_data.sampling_api import sample_height

        self.approximate_height = sample_height(
            self, tile_atlas, self.view_world_position
        )
