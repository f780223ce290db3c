"""Shared device coordinate math — the torch twin of the JAX package's ``ops/coords.py``.

Each helper mirrors a function of the reference's functions.wgsl (cited per
function) on batched torch tensors in f32 / int32, with the JAX package's
operation order, so that the two packages agree bit for bit where the
operations are exact. Coordinates are carried unpacked as (side, lod, xy,
uv) tensors:

* ``side`` int32 (...,)      cube face 0-5
* ``lod``  int32 (...,)      quadtree depth, 0 = coarsest
* ``xy``   int32 (..., 2)    tile index at that lod
* ``uv``   f32  (..., 2)     position within the tile, [0, 1]

Every 3-vector norm is written out as ``sqrt(x*x + y*y + z*z)``, summed
left to right as the JAX package's reductions sum: node selection at
planetary scale turns on single ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import C_SQR, SIDE_LOCAL_MATRICES
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig, TaylorParams

# per-side cube placement (signed permutations: exact in f32)
SIDE_MATS = np.asarray(SIDE_LOCAL_MATRICES, np.float32)  # (6, 3, 3)
_SIDE_MATS_DEV: dict = {}


def side_mats(device) -> torch.Tensor:
    """:data:`SIDE_MATS` as a (6, 3, 3) f32 tensor on ``device``, copied
    there once."""
    key = str(device)
    if key not in _SIDE_MATS_DEV:
        _SIDE_MATS_DEV[key] = torch.from_numpy(SIDE_MATS).to(device)
    return _SIDE_MATS_DEV[key]


def tile_count(lod: torch.Tensor) -> torch.Tensor:
    """f32 tiles-per-axis (functions.wgsl:156)."""
    return torch.exp2(lod.to(torch.float32))


def take_side_rows(table: torch.Tensor, side: torch.Tensor, side_count: int = 6):
    """Per-lane row of a tiny per-side table."""
    if side_count == 1:
        return table[0].expand(side.shape + table.shape[1:])
    return table[side.long()]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of (..., 3), summed x, y, z in order."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def _apply_mat3(m, v):
    """Elementwise 3x3 matrix-vector product for batched 3-vectors (no
    matmul library call, whose precision a global TF32 flag can lower)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        dim=-1,
    )


def compute_local_position(side, lod, xy, uv, spherical: bool):
    """Coordinate -> unit local position (functions.wgsl:73-96), (..., 3) f32."""
    uv01 = (xy.to(torch.float32) + uv) / tile_count(lod)[..., None]
    if not spherical:
        return torch.stack(
            [uv01[..., 0] - 0.5, torch.zeros_like(uv01[..., 0]), uv01[..., 1] - 0.5],
            dim=-1,
        )
    w = (uv01 - 0.5) / 0.5
    p = w / torch.sqrt(1.0 + C_SQR - C_SQR * w * w)
    mats = take_side_rows(side_mats(uv.device), side)  # (..., 3, 3)
    # signed permutation rows: each product is exact, so the sum is too
    px, py = p[..., 0:1], p[..., 1:2]
    cube = mats[..., 0] * px + mats[..., 1] * py + mats[..., 2]
    return cube / norm3(cube)[..., None]


def position_local_to_world(local_position, world_from_local):
    """Affine transform (functions.wgsl:26-29). ``world_from_local`` is (3,4) f32."""
    return _apply_mat3(world_from_local, local_position) + world_from_local[:, 3]


def normal_local_to_world(local_position, normal_matrix, spherical: bool):
    """Surface normal (functions.wgsl:14-24): the local normal is the local
    position for spheres, +Y for planes, mapped by the inverse-transpose."""
    if spherical:
        n = _apply_mat3(normal_matrix, local_position)
    else:
        n = normal_matrix[:, 1].expand(local_position.shape)
    return n / norm3(n)[..., None]


def coordinate_change_lod(lod, xy, uv, new_lod):
    """Re-anchor (xy, uv) at a different lod (functions.wgsl:164-188).

    ``new_lod`` broadcasts against ``lod``. Returns (new_lod, xy', uv').
    Both directions are computed and selected; diff == 0 keeps the inputs
    bit-identical (the WGSL early-returns).
    """
    if not isinstance(new_lod, torch.Tensor):
        new_lod = torch.full((), new_lod, dtype=torch.int32, device=lod.device)
    new_lod = new_lod.expand(lod.shape)
    diff = new_lod - lod
    pos_shift = diff.clamp(min=0)
    neg_shift = (-diff).clamp(min=0)
    delta_size = torch.exp2(diff.to(torch.float32))[..., None]

    # lod increases: xy = xy * 2^d + floor(uv * 2^d); uv = frac(uv * 2^d)
    scaled_uv = uv * delta_size
    floor_uv = torch.floor(scaled_uv)
    up_xy = (xy << pos_shift[..., None]) + floor_uv.to(torch.int32)
    up_uv = scaled_uv - floor_uv

    # lod decreases: xy' = xy >> d; uv = ((xy & (2^d - 1)) + uv) * 2^-d
    mask = (torch.ones_like(neg_shift) << neg_shift)[..., None] - 1
    down_xy = xy >> neg_shift[..., None]
    down_uv = ((xy & mask).to(torch.float32) + uv) * delta_size

    same = (diff == 0)[..., None]
    up = (diff > 0)[..., None]
    out_xy = torch.where(same, xy, torch.where(up, up_xy, down_xy))
    out_uv = torch.where(same, uv, torch.where(up, up_uv, down_uv))
    return new_lod, out_xy, out_uv


def planar_view_distance(lod, xy, uv, uniforms: FrameUniforms):
    """View distance for planar terrains, componentwise (the same op order
    as the JAX package's planar_view_distance)."""
    uv01 = (xy.to(torch.float32) + uv) / tile_count(lod)[..., None]
    lx = uv01[..., 0] - 0.5
    lz = uv01[..., 1] - 0.5
    m = uniforms.world_from_local  # (3, 4)
    n = uniforms.normal_matrix[:, 1]
    n = n / torch.linalg.vector_norm(n)
    base = m[:, 3] + uniforms.approximate_height * n - uniforms.view_world_position
    dx = m[0, 0] * lx + m[0, 2] * lz + base[0]
    dy = m[1, 0] * lx + m[1, 2] * lz + base[1]
    dz = m[2, 0] * lx + m[2, 2] * lz + base[2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def compute_relative_position(side, lod, xy, uv, taylor: TaylorParams, origin_lod: int,
                              side_count: int = 6):
    """Taylor-series view-relative position (functions.wgsl:98-115).

    Returns (..., 3) f32 positions relative to the view world position.
    """
    _, oxy, ouv = coordinate_change_lod(lod, xy, uv, origin_lod)
    origin_xy = take_side_rows(taylor.origin_xy, side, side_count)  # (..., 2)
    origin_uv = take_side_rows(taylor.origin_uv, side, side_count)
    origin_count = float(2.0 ** origin_lod)
    rel_st = ((oxy - origin_xy).to(torch.float32) + (ouv - origin_uv)) / origin_count
    s = rel_st[..., 0:1]
    t = rel_st[..., 1:2]

    def row(tbl):
        return take_side_rows(tbl, side, side_count)

    return (
        row(taylor.c)
        + row(taylor.c_s) * s
        + row(taylor.c_t) * t
        + row(taylor.c_ss) * s * s
        + row(taylor.c_st) * s * t
        + row(taylor.c_tt) * t * t
    )


def approximate_view_distance(side, lod, xy, uv, uniforms: FrameUniforms,
                              cfg: StaticTerrainConfig):
    """View distance of a coordinate at the approximate terrain height
    (functions.wgsl:117-131), with the HIGH_PRECISION Taylor fallback
    below ``precision_threshold_distance``."""
    if not cfg.spherical and not cfg.high_precision:
        return planar_view_distance(lod, xy, uv, uniforms)
    local = compute_local_position(side, lod, xy, uv, cfg.spherical)
    world = position_local_to_world(local, uniforms.world_from_local)
    normal = normal_local_to_world(local, uniforms.normal_matrix, cfg.spherical)
    sample = world + uniforms.approximate_height * normal
    view_distance = norm3(sample - uniforms.view_world_position)
    if cfg.high_precision:
        relative = compute_relative_position(
            side, lod, xy, uv, uniforms.taylor, cfg.origin_lod, cfg.side_count
        )
        hp_distance = norm3(relative + uniforms.approximate_height * normal)
        view_distance = torch.where(
            view_distance < uniforms.precision_threshold_distance, hp_distance, view_distance
        )
    return view_distance


def compute_subdivision_coordinate(side, lod, xy, taylor: TaylorParams,
                                   origin_lod: int, side_count: int = 6):
    """Closest point of a tile to the view, in uv space
    (functions.wgsl:133-154). Input coordinates have uv = 0; returns uv."""
    view_xy = take_side_rows(taylor.origin_xy, side, side_count)
    view_uv = take_side_rows(taylor.origin_uv, side, side_count)
    origin = torch.full(lod.shape, origin_lod, dtype=torch.int32, device=lod.device)
    _, vxy, vuv = coordinate_change_lod(origin, view_xy, view_uv, lod)
    offset = vxy - xy
    zero = torch.zeros((), dtype=vuv.dtype, device=vuv.device)
    one = torch.ones((), dtype=vuv.dtype, device=vuv.device)
    return torch.where(offset < 0, zero, torch.where(offset > 0, one, vuv))


def compute_morph(lod, uv, view_distance, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """CDLOD vertex morph toward the even-grid uv (functions.wgsl:35-49)."""
    if not cfg.morph:
        return uv
    grid_size = float(cfg.grid_size)
    even_uv = ((uv * grid_size).to(torch.int32) & ~1).to(torch.float32) / grid_size
    target_lod = torch.log2(2.0 * uniforms.morph_distance / view_distance)
    lod_f = lod.to(torch.float32)
    a = lod_f + uniforms.morph_range
    ratio = torch.where(
        lod == 0,
        torch.zeros((), dtype=torch.float32, device=lod.device),
        ((target_lod - a) / (lod_f - a)).clamp(0.0, 1.0),
    )[..., None]
    return uv + (even_uv - uv) * ratio  # mix(uv, even_uv, ratio)


def compute_tile_uv(vertex_index, cfg: StaticTerrainConfig):
    """Degenerate-triangle-strip grid uv per vertex (functions.wgsl:64-71).

    ``vertex_index`` int32 (...,) -> uv (..., 2) f32.
    """
    vpr = cfg.vertices_per_row
    grid_index = vertex_index % cfg.vertices_per_tile
    row_index = (grid_index % vpr).clamp(1, vpr - 2) - 1
    column_index = grid_index // vpr
    u = (column_index + (row_index & 1)).to(torch.float32)
    v = (row_index >> 1).to(torch.float32)
    return torch.stack([u, v], dim=-1) / float(cfg.grid_size)


def compute_blend(view_distance, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Blend lod + ratio from view distance (functions.wgsl:51-62).

    Returns (lod int32, ratio f32)."""
    # the cap in f32 arithmetic, as the JAX package computes it
    cap = float(np.float32(cfg.lod_count) - np.float32(0.00001))
    target_lod = torch.log2(uniforms.blend_distance / view_distance).clamp(max=cap)
    # Rust `as u32` saturates negatives to 0 (tile_tree.rs:227-228)
    lod = target_lod.clamp(min=0.0).to(torch.int32)
    if cfg.blend:
        lod_f = lod.to(torch.float32)
        a = lod_f + uniforms.blend_range
        ratio = torch.where(
            lod == 0,
            torch.zeros((), dtype=torch.float32, device=lod.device),
            ((target_lod - a) / (lod_f - a)).clamp(0.0, 1.0),
        )
    else:
        ratio = torch.zeros_like(target_lod)
    return lod, ratio


def tile_visible(side, lod, xy, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Conservative frustum test of a tile's bounding volume.

    Planar tiles are exact parallelepipeds (affine image of rect x height),
    so max-over-corners equals the box support function:
    d_max = p . center + sum |p . half_axis|. A cube-sphere tile gets one
    bounding sphere: centred on the tile-centre surface point at the middle
    height, with radius the arc over the tile's angular span (1.2x covers
    the C_SQR warp's stretch) plus the height range. Returns (...,) bool.
    """
    planes = uniforms.culling_planes  # (5, 4)
    zero = torch.zeros((), dtype=torch.float32, device=planes.device)
    hmin = torch.minimum(uniforms.min_height, zero)
    hmax = torch.maximum(uniforms.max_height, zero)
    if cfg.spherical:
        center_uv = torch.full(xy.shape, 0.5, dtype=torch.float32, device=xy.device)
        local = compute_local_position(side, lod, xy, center_uv, True)
        world = position_local_to_world(local, uniforms.world_from_local)
        normal = normal_local_to_world(local, uniforms.normal_matrix, True)
        hmid = 0.5 * (hmin + hmax)
        p = world + hmid * normal
        d = (
            p[..., 0, None] * planes[:, 0]
            + p[..., 1, None] * planes[:, 1]
            + p[..., 2, None] * planes[:, 2]
            + planes[:, 3]
        )  # (..., 5)
        # f32(1.2 * pi / 2) and f32(pi), as the JAX package rounds them
        theta = torch.clamp(1.2 * (np.pi / 2.0) * torch.exp2(-lod.to(torch.float32)),
                            max=float(np.float32(np.pi)))
        r = (uniforms.terrain_scale + torch.abs(hmax)) * theta + (hmax - hmin)
        return torch.all(d + r[..., None] >= 0.0, dim=-1)
    m = uniforms.world_from_local  # (3, 4)
    inv_count = torch.exp2(-lod.to(torch.float32))
    n_up = uniforms.normal_matrix[:, 1]
    n_up = n_up / torch.linalg.vector_norm(n_up)
    cx = (xy[..., 0].to(torch.float32) + 0.5) * inv_count - 0.5
    cz = (xy[..., 1].to(torch.float32) + 0.5) * inv_count - 0.5
    hmid = 0.5 * (hmin + hmax)
    hhalf = 0.5 * (hmax - hmin)
    px = m[0, 0] * cx + m[0, 2] * cz + m[0, 3] + hmid * n_up[0]
    py = m[1, 0] * cx + m[1, 2] * cz + m[1, 3] + hmid * n_up[1]
    pz = m[2, 0] * cx + m[2, 2] * cz + m[2, 3] + hmid * n_up[2]
    pn = planes[:, :3]  # (5, 3)
    pa = torch.abs(_dot3(pn, m[:, 0]))  # (5,) |p . Mcol0|
    pc = torch.abs(_dot3(pn, m[:, 2]))
    ph = torch.abs(_dot3(pn, n_up)) * hhalf
    d = (
        px[..., None] * planes[:, 0]
        + py[..., None] * planes[:, 1]
        + pz[..., None] * planes[:, 2]
        + planes[:, 3]
    )
    r = (pa + pc) * (0.5 * inv_count[..., None]) + ph
    return torch.all(d + r >= 0.0, dim=-1)


def _dot3(rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(5, 3) @ (3,) as explicit f32 products (no matmul library call)."""
    return rows[:, 0] * v[0] + rows[:, 1] * v[1] + rows[:, 2] * v[2]


def lookup_entries(entries, side, lod, xy, cfg: StaticTerrainConfig):
    """Tile-tree entry lookup for flat (F,) coordinate batches: plain
    integer indexing (exact), where the JAX package uses a one-hot matmul
    because the TPU has no fast gather.

    ``xy`` must already be tree-wrapped (callers pass xy % tree_size).
    Returns (atlas_index i32, atlas_lod i32).
    """
    lod_c = lod.clamp(0, cfg.lod_count - 1).long()
    e = entries[side.long(), lod_c, xy[..., 0].long(), xy[..., 1].long()]
    return e[..., 0], e[..., 1]


def lookup_tile_tree_entry(entries, side, lod, xy, cfg: StaticTerrainConfig):
    """Wrapping-modulo tile tree entry gather (functions.wgsl:198-206).

    ``entries`` is (sides, lods, tree, tree, 2) int32; returns
    (atlas_index, atlas_lod) int32 tensors of the coordinates' shape.
    """
    tree_xy = (xy % cfg.tree_size).long()
    lod_c = lod.clamp(0, cfg.lod_count - 1).long()
    entry = entries[side.long(), lod_c, tree_xy[..., 0], tree_xy[..., 1]]
    return entry[..., 0], entry[..., 1]


def lookup_tile(entries, side, lod, xy, uv, blend_lod, cfg: StaticTerrainConfig,
                lod_offset: int = 0):
    """The best-loaded atlas tile of a coordinate at the blend lod
    (functions.wgsl:232-246, the path without TILE_TREE_LOD).

    Returns (atlas_index i32, atlas_lod i32, atlas_xy i32, atlas_uv f32);
    atlas_index is -1 where nothing is loaded.
    """
    target = (blend_lod - lod_offset).clamp(min=0)
    t_lod, t_xy, t_uv = coordinate_change_lod(lod, xy, uv, target)
    atlas_index, atlas_lod = lookup_tile_tree_entry(entries, side, t_lod, t_xy, cfg)
    # invalid entries carry atlas_lod -1: keep the lod change in range, the
    # caller masks on atlas_index < 0
    safe_lod = torch.where(atlas_lod < 0, t_lod, atlas_lod)
    a_lod, a_xy, a_uv = coordinate_change_lod(t_lod, t_xy, t_uv, safe_lod)
    return atlas_index, a_lod, a_xy, a_uv


def compute_tile_tree_uv(origins, side, lod, xy, uv, cfg: StaticTerrainConfig):
    """Position of a coordinate within the wrapping tree window
    (functions.wgsl:190-195). Used by :func:`lookup_best`."""
    origin_xy = origins[side.long(), lod.long()]  # (..., 2)
    tree_size = tile_count(lod).clamp(max=float(cfg.tree_size))[..., None]
    return ((xy - origin_xy).to(torch.float32) + uv) / tree_size


def lookup_best(entries, origins, side, lod, xy, uv, cfg: StaticTerrainConfig):
    """Walk down lods while the coordinate stays inside the tree window, then
    take that entry (functions.wgsl:209-230): the fixed-trip-count form of
    the WGSL while-loop, as in the JAX package.

    Returns (atlas_index, atlas_lod, atlas_xy, atlas_uv).
    """
    best_lod = torch.zeros_like(lod)
    for cand in range(1, cfg.lod_count):
        c_lod, c_xy, c_uv = coordinate_change_lod(lod, xy, uv, cand)
        tuv = compute_tile_tree_uv(origins, side, c_lod, c_xy, c_uv, cfg)
        inside = torch.all((tuv > 0.0) & (tuv < 1.0), dim=-1)
        # the WGSL keeps ascending while inside; once outside it stops
        keep = inside & (best_lod == cand - 1)
        best_lod = torch.where(keep, cand, best_lod)
    b_lod, b_xy, b_uv = coordinate_change_lod(lod, xy, uv, best_lod)
    atlas_index, atlas_lod = lookup_tile_tree_entry(entries, side, b_lod, b_xy, cfg)
    safe_lod = torch.where(atlas_lod < 0, b_lod, atlas_lod)
    a_lod, a_xy, a_uv = coordinate_change_lod(b_lod, b_xy, b_uv, safe_lod)
    return atlas_index, a_lod, a_xy, a_uv
