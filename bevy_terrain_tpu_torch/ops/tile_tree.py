"""Vectorized tile-tree request scan (device) + host origin computation.

Torch twin of the JAX package's ``ops/tile_tree.py``. It replaces the
serial CPU hot loop of the reference (src/terrain_data/tile_tree.rs:268-333:
per side x lod x tree_size^2 tile, compute the closest-point distance to the
view and derive the requested/released state) with one vectorized op graph
over the whole (sides, lods, tree, tree) cube.

Host precomputes per-(side, lod) f64 anchors (the view position in tile
units and the tree origin — tiny, exact); the device computes the per-slot
distances and the request mask in f32 with the same closest-point rule.
As in the JAX package, the pipeline does not call the device twin: each
frame's requests come from the host scan (terrain_data/tile_tree.py).
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import Coordinate
from bevy_terrain_tpu_torch.ops import coords
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig


# ---------------------------------------------------------------------------
# Host prologue (numpy f64): origins + view anchors, reference
# tile_tree.rs:175-191
# ---------------------------------------------------------------------------


def compute_view_anchors(model, view_world_position, lod_count: int, tree_size: int):
    """Per-(side, lod) tree origin and view position in tile units.

    Mirrors ``compute_tree_xy`` / ``compute_origin``
    (reference tile_tree.rs:175-191) for all sides and lods at once.

    Returns (origins i32 (S,L,2), view_tile_int i32 (S,L,2),
    view_tile_frac f32 (S,L,2)).
    """
    view_coordinate = Coordinate.from_world_position(view_world_position, model)
    sides = model.side_count
    side_uv = np.zeros((sides, 2), np.float64)
    for side in range(sides):
        side_uv[side] = view_coordinate.project_to_side(side, model).uv

    lods = np.arange(lod_count)
    tile_counts = (1 << lods).astype(np.float64)  # (L,)
    # scale and clamp to the tree bounds (tile_tree.rs:175-178)
    tree_xy = np.minimum(
        side_uv[:, None, :] * tile_counts[None, :, None],
        tile_counts[None, :, None] - 0.000001,
    )  # (S, L, 2)

    origins = np.clip(
        np.round(tree_xy - 0.5 * tree_size),
        0.0,
        np.maximum(tile_counts[None, :, None] - tree_size, 0.0),
    ).astype(np.int64)  # (S, L, 2) — tile_tree.rs:180-191

    view_tile_int = np.floor(tree_xy).astype(np.int64)
    view_tile_frac = (tree_xy % 1.0).astype(np.float32)
    return (
        origins.astype(np.int32),
        view_tile_int.astype(np.int32),
        view_tile_frac,
    )


# ---------------------------------------------------------------------------
# Device request scan
# ---------------------------------------------------------------------------


def slot_coordinates(origins: torch.Tensor, cfg: StaticTerrainConfig) -> torch.Tensor:
    """Per-slot tile coordinate of the wrapping tree cube.

    Slot (i, j) of layer (side, lod) holds the tile with
    ``x = origin + ((i - origin) mod tree)`` so that ``x % tree == i``
    (the wrapping storage rule of tile_tree.rs:300-305).

    Returns xy int32 (S, L, T, T, 2) on the device of ``origins``.
    """
    t = cfg.tree_size
    idx = torch.arange(t, dtype=torch.int32, device=origins.device)
    ij = torch.stack(
        torch.meshgrid(idx, idx, indexing="ij"), dim=-1
    )  # (T, T, 2) with ij[...,0] = i (x slot)
    origin = origins[:, :, None, None, :]  # (S, L, 1, 1, 2)
    return origin + torch.remainder(ij[None, None] - origin, t)


def tile_tree_update(uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Compute per-slot tile coordinates and the request mask, as torch ops
    on the device of ``uniforms``.

    The distance rule mirrors ``compute_tile_distance`` + the request state
    decision (reference tile_tree.rs:193-221, :289-298): the closest point
    of the tile to the view (component-wise clamped view offset) is placed
    at the approximate height, and the tile is requested when
    ``distance < load_distance / 2^lod`` (lod 0 always requested).

    Returns (tile_xy i32 (S,L,T,T,2), requested bool (S,L,T,T)).
    """
    S, L, T = cfg.side_count, cfg.lod_count, cfg.tree_size
    device = uniforms.origins.device
    tile_xy = slot_coordinates(uniforms.origins, cfg)  # (S,L,T,T,2)

    view_int = uniforms.view_tile_int[:, :, None, None, :]
    view_frac = uniforms.view_tile_frac[:, :, None, None, :]
    tile_offset = view_int - tile_xy
    zero = torch.zeros((), dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    offset = torch.where(
        tile_offset < 0, zero, torch.where(tile_offset > 0, one, view_frac)
    )  # closest-point uv (tile_tree.rs:203-214)

    side = torch.arange(S, dtype=torch.int32, device=device)[:, None, None, None]
    side = side.expand(S, L, T, T)
    lod = torch.arange(L, dtype=torch.int32, device=device)[None, :, None, None]
    lod = lod.expand(S, L, T, T)

    distance = coords.approximate_view_distance(
        side, lod, tile_xy, offset, uniforms, cfg
    )
    load_distance = uniforms.load_distance / coords.tile_count(lod)
    requested = (lod == 0) | (distance < load_distance)
    return tile_xy, requested


def tile_tree_update_host(model, view_world_position, uniforms, cfg):
    """Exact f64 host twin of :func:`tile_tree_update` (numpy).

    Mirrors tile_tree.rs:268-333 exactly (including the f64 world-space
    distance). Used for validation and as a fallback when a caller wants the
    reference-exact request decisions.
    """
    S, L, T = cfg.side_count, cfg.lod_count, cfg.tree_size
    origins, view_int, view_frac = compute_view_anchors(
        model, view_world_position, L, T
    )
    idx = np.arange(T)
    ij = np.stack(np.meshgrid(idx, idx, indexing="ij"), axis=-1)
    origin = origins[:, :, None, None, :].astype(np.int64)
    tile_xy = origin + ((ij[None, None] - origin) % T)

    tile_offset = view_int[:, :, None, None, :] - tile_xy
    offset = np.where(
        tile_offset < 0,
        0.0,
        np.where(tile_offset > 0, 1.0, view_frac[:, :, None, None, :]),
    )

    lods = np.arange(L)
    counts = (1 << lods).astype(np.float64)[None, :, None, None]
    uv = (tile_xy + offset) / counts[..., None]

    approx_h = float(uniforms.approximate_height)
    world = np.zeros((S, L, T, T, 3))
    for s in range(S):
        for l in range(L):
            for i in range(T):
                for j in range(T):
                    world[s, l, i, j] = Coordinate(s, uv[s, l, i, j]).world_position(
                        model, approx_h
                    )
    dist = np.linalg.norm(world - np.asarray(view_world_position), axis=-1)
    load_distance = float(uniforms.load_distance) / counts
    requested = (lods[None, :, None, None] == 0) | (dist < load_distance)
    return tile_xy.astype(np.int32), requested
