"""Tiled rasterizer: terrain frame products -> framebuffer.

Torch twin of the JAX package's ``render/raster.py``: the per-pixel half
of the reference's fragment stage (fragment.wgsl:35-113), for captures,
goldens, debug stills and offline tooling. Plain torch ops on the device of
the positions it is given, f32 throughout; no hand-written kernel.

The design is the JAX package's:

* **Hierarchical binning by sort compaction**: bins form a mip pyramid
  (level-0 bins of ``bin_px``, each coarser level 2x); a triangle lands at
  the level where its AABB spans at most 2x2 bins and emits <= 4 (bin,
  triangle) pairs. One sort of a packed 64-bit key [bin | depth priority |
  triangle id] and a rank pass (each bin's first index by binary search)
  build dense per-bin candidate lists; per-level caps are static capacities whose
  clamping is counted (``bin_overflow``), never silent.
* **Edge functions**: 3 edges + the screen-affine NDC depth of a candidate
  are a (4, 3) coefficient matrix, evaluated per pixel as ``(a * x + b *
  y) + c``. Elementwise, in that one order for every candidate, and never
  through a matmul: the two triangles on a shared edge get exact negations
  (``edge_coef``), the CPU and the card give the same bits, and no TF32
  setting of the caller can enter. The depth race is a running max over
  candidate chunks (reverse-Z, math/frustum.perspective); ``torch.max``
  keeps the first maximum, a later chunk wins only when strictly nearer.
* **Perspective-correct resolve**: the winning triangle id per pixel
  gathers its 3 vertices; barycentrics are recomputed per pixel and
  corrected with the vertices' 1/w.

D3D/Vulkan raster contract: pixel centres at +0.5, vertices snapped to a
1/256 px grid, top-left fill rule (:func:`raster_coverage_rule`), so shared
edges are drawn exactly once. Triangles with a vertex at w <= near_eps are
culled and counted (``near_culled``), not clipped (MIGRATING.md).

:func:`rasterize_grid` reads nothing back to the host: the counters stay
0-d device tensors, and its constant tables (triangle indices, bin
geometry) are built once per shape and device and cached.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch.ops.meshgen import GridMeshOutput


class RasterOutput(NamedTuple):
    """Per-pixel frame buffers (H, W, ...) plus loss counters."""

    depth: torch.Tensor  # (H, W) f32 NDC depth (reverse-Z: 0 = far/empty)
    tri_id: torch.Tensor  # (H, W) i32 global triangle id, -1 = uncovered
    covered: torch.Tensor  # (H, W) bool
    bary: torch.Tensor  # (H, W, 3) f32 perspective-correct barycentrics
    # verts of the winning triangle, flat indices into (F*G1*G1):
    vert_idx: torch.Tensor  # (H, W, 3) i32 (garbage where uncovered)
    near_culled: torch.Tensor  # () i32 triangles cut by the near plane
    bin_overflow: torch.Tensor  # () i32 candidates lost to per-level caps


def _triangle_vertex_indices(F: int, R: int, C: int | None = None) -> np.ndarray:
    """Static (T, 3) flat vertex indices for the grid triangulation.

    Each quad (r, c) splits along the diagonal the reference's strip order
    induces (functions.wgsl:64-71): tri 0 = (v[r,c], v[r,c+1], v[r+1,c]),
    tri 1 = (v[r+1,c], v[r,c+1], v[r+1,c+1]). T = F * (R-1) * (C-1) * 2.
    """
    if C is None:
        C = R
    r = np.arange(R - 1).reshape(R - 1, 1)
    c = np.arange(C - 1).reshape(1, C - 1)
    v00 = r * C + c
    v01 = r * C + (c + 1)
    v10 = (r + 1) * C + c
    v11 = (r + 1) * C + (c + 1)
    tris = np.stack(
        [np.stack([v00, v01, v10], axis=-1), np.stack([v10, v01, v11], axis=-1)], axis=2
    )  # (R-1, C-1, 2, 3)
    per_tile = tris.reshape(-1, 3)
    base = (np.arange(F) * (R * C)).reshape(F, 1, 1)
    return (base + per_tile[None]).reshape(-1, 3).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _triangle_table(F: int, R: int, C: int, device: torch.device) -> torch.Tensor:
    """:func:`_triangle_vertex_indices` as an int64 tensor on ``device``,
    built once per shape (at capacity 4096 with skirts, 2.65 M triangles)."""
    return torch.from_numpy(_triangle_vertex_indices(F, R, C).astype(np.int64)).to(device)


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host constant on ``device`` without a stream sync: numpy goes
    through pinned memory with a non-blocking copy."""
    host = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _f32_on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return _to_device(np.asarray(x, np.float32), device)


def _project(positions, view_proj, width, height):
    """World -> (screen_x, screen_y, ndc_depth, w) per vertex.

    ``view_proj`` is column-vector convention (math/frustum.
    view_projection): clip = VP @ [p; 1]. Screen origin top-left, pixel
    centres at +0.5, y down. The product is written out elementwise in one
    order (no matmul, whose precision a TF32 switch lowers)."""
    vp = _f32_on(view_proj, positions.device)
    t = positions[:, None, :] * vp[:, :3]  # (N, 4, 3)
    clip = ((t[..., 0] + t[..., 1]) + t[..., 2]) + vp[:, 3]
    w = clip[:, 3]
    safe_w = torch.where(w.abs() < 1e-12, 1e-12, w)
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    # GPU-style fixed-point vertex snapping (D3D's 16.8 raster grid):
    # coincident-but-not-bitwise vertices of adjacent tiles collapse to
    # the same raster position, so the canonical-edge watertightness holds
    # across tiles too (torch.round rounds half to even, as jnp.round)
    sx = torch.round(sx * 256.0) * (1.0 / 256.0)
    sy = torch.round(sy * 256.0) * (1.0 / 256.0)
    return sx, sy, ndc[:, 2], w


def raster_coverage_rule(e, is_top_left):
    """Top-left fill rule: pixels on a shared edge belong to exactly one
    triangle (e > 0, or e == 0 when the edge is a top/left edge)."""
    return (e > 0) | ((e == 0) & is_top_left)


def edge_coef(x0, y0, x1, y1):
    """Watertight edge coefficients: evaluate every edge in a CANONICAL
    endpoint order (lexicographic by screen coordinate) and fold the
    orientation back as a +-1 factor. Two triangles sharing an edge then
    compute bitwise-identical (a, b, c) before their opposite signs, so
    their E values are exact f32 negations and, with the fill rule, every
    boundary pixel lands in exactly one triangle."""
    swap = (x0 > x1) | ((x0 == x1) & (y0 > y1))
    xl = torch.where(swap, x1, x0)
    yl = torch.where(swap, y1, y0)
    xh = torch.where(swap, x0, x1)
    yh = torch.where(swap, y0, y1)
    a = -(yh - yl)
    b = xh - xl
    c = (yh - yl) * xl - (xh - xl) * yl
    sgn = torch.where(swap, -1.0, 1.0)
    return a * sgn, b * sgn, c * sgn


def _level_caps(bin_cap: int, levels: int):
    """Per-level candidate capacities: level 0 gets ``bin_cap``; coarser
    levels halve (floor 16)."""
    return tuple(max(bin_cap >> (L + 1), 16) if L else bin_cap for L in range(levels))


class _BinGrid(NamedTuple):
    """Host-static bin pyramid of one (width, height, bin_px, bin_cap),
    with its device tables."""

    nbx: int
    nby: int
    levels: int
    caps: tuple
    key_off: np.ndarray  # (levels + 1,) flat-key offset of each level
    table_base: np.ndarray  # (levels + 1,) flat-table offset of each level
    nb_l: list  # bins per level
    t_nbx: torch.Tensor  # (levels,) i32 bins across per level
    t_key_off: torch.Tensor  # (levels,) i32
    t_caps: torch.Tensor  # (levels,) i64
    t_table_base: torch.Tensor  # (levels,) i64
    ups: tuple  # per level (NB,) i64: level-0 bin -> its level-L bin
    pix_x: torch.Tensor  # (NB, P, 1) f32 pixel-centre x
    pix_y: torch.Tensor  # (NB, P, 1) f32 pixel-centre y


@functools.lru_cache(maxsize=16)
def _pixel_centres(width: int, height: int, device: torch.device):
    """((1, W), (H, 1)) f32 pixel-centre coordinates of the image."""
    return (_to_device((np.arange(width, dtype=np.float32) + 0.5)[None, :], device),
            _to_device((np.arange(height, dtype=np.float32) + 0.5)[:, None], device))


@functools.lru_cache(maxsize=16)
def _bin_grid(width: int, height: int, bin_px: int, bin_cap: int,
              device: torch.device) -> _BinGrid:
    nbx = -(-width // bin_px)
    nby = -(-height // bin_px)
    NB = nbx * nby
    levels = max(int(np.ceil(np.log2(max(nbx, nby)))), 0) + 1
    caps = _level_caps(bin_cap, levels)
    nbx_l = [-(-nbx // (1 << L)) for L in range(levels)]
    nby_l = [-(-nby // (1 << L)) for L in range(levels)]
    nb_l = [a * b for a, b in zip(nbx_l, nby_l)]
    key_off = np.concatenate([[0], np.cumsum(nb_l)]).astype(np.int64)
    table_base = np.concatenate(
        [[0], np.cumsum([nb_l[L] * caps[L] for L in range(levels)])]).astype(np.int64)
    b0 = np.arange(NB)
    b0x, b0y = b0 % nbx, b0 // nbx
    ups = tuple(_to_device(((b0y >> L) * nbx_l[L] + (b0x >> L)).astype(np.int64), device)
                for L in range(levels))
    local = np.arange(bin_px, dtype=np.float32) + 0.5
    lx = np.tile(local, bin_px)  # (P,) x-fast
    ly = np.repeat(local, bin_px)
    ox = (b0 % nbx).astype(np.float32) * bin_px
    oy = (b0 // nbx).astype(np.float32) * bin_px
    return _BinGrid(
        nbx=nbx, nby=nby, levels=levels, caps=caps, key_off=key_off, table_base=table_base,
        nb_l=nb_l,
        t_nbx=_to_device(np.asarray(nbx_l, np.int32), device),
        t_key_off=_to_device(key_off[:levels].astype(np.int32), device),
        t_caps=_to_device(np.asarray(caps, np.int64), device),
        t_table_base=_to_device(table_base[:levels], device),
        ups=ups,
        pix_x=_to_device((ox[:, None] + lx[None, :])[..., None], device),
        pix_y=_to_device((oy[:, None] + ly[None, :])[..., None], device),
    )


def _sort_pairs(key, znear_key, T: int, nkeys: int):
    """Sort the (T, 4) pairs by (bin key, depth priority, triangle id).
    Returns (sorted keys, sorted triangle ids), int64.

    The three fields are packed into one 64-bit key as the JAX package
    packs its two uint32 words (the high word [bin | top depth bits], the
    low word [further depth bits | triangle id]); the high word's top bit
    is flipped so that the signed order is the unsigned one. The triangle
    id makes the order strict, so any sort gives the same result. Beyond
    24 key bits or 31 id bits, a lexicographic stable sort of the three."""
    kbits = max(int(np.ceil(np.log2(nkeys + 1))), 1)
    tbits = max(int(np.ceil(np.log2(max(T, 2)))), 1)
    if kbits > 24 or tbits > 31:
        return _sort_pairs_stable(key, znear_key, T)
    tri = torch.arange(T, dtype=torch.int64, device=key.device)[:, None].expand(T, 4).reshape(-1)
    key = key.reshape(-1).to(torch.int64)
    znear_key = znear_key.reshape(-1)
    dhi = 32 - kbits  # depth bits carried in the high word
    dlo = max(32 - tbits, 0)  # further depth bits in the low word
    # bitcast to uint32 ^ 0x80000000: the order-preserving unsigned value
    dprio = znear_key.to(torch.int64) + 2**31
    high = (key << dhi) | (dprio >> kbits)
    d_rest = (dprio & ((1 << kbits) - 1)) >> max(kbits - dlo, 0)
    low = (d_rest << tbits) | tri
    packed = torch.sort((high - 2**31) * 2**32 + low).values
    s_key = ((packed >> 32) + 2**31) >> dhi
    s_tri = packed & ((1 << tbits) - 1)
    return s_key, s_tri


def _sort_pairs_stable(key, znear_key, T: int):
    """:func:`_sort_pairs` by two stable sorts (the pairs are in triangle
    order): by depth priority, then by bin key."""
    tri = torch.arange(T, dtype=torch.int64, device=key.device)[:, None].expand(T, 4).reshape(-1)
    key = key.reshape(-1).to(torch.int64)
    perm = torch.sort(znear_key.reshape(-1), stable=True).indices
    perm = perm[torch.sort(key[perm], stable=True).indices]
    return key[perm], tri[perm]


class _Pairs(NamedTuple):
    """The products of :func:`_bin_pairs`: each triangle's screen data and
    its (T, 4) bin pairs, which :func:`_sort_pairs` orders and
    :func:`_bin_table` files."""

    sx: torch.Tensor  # (V,) f32 snapped screen x per vertex
    sy: torch.Tensor  # (V,) f32 snapped screen y
    w: torch.Tensor  # (V,) f32 clip w
    tri_vidx: torch.Tensor  # (T, 3) i64
    coefs: torch.Tensor  # (T, 3, 4) f32 rows a, b, c of planes e0, e1, e2, z
    top_left: torch.Tensor  # (T, 3) bool fill-rule flags of the three edges
    key: torch.Tensor  # (T, 4) i32 flat bin key per pair, nkeys = none
    znear_key: torch.Tensor  # (T, 4) i32 near-first depth key
    nkeys: int
    near_culled: torch.Tensor
    grid: _BinGrid


class _Binned(NamedTuple):
    """The products of :func:`_bin`, which :func:`_scan` and
    :func:`_resolve` read."""

    sx: torch.Tensor  # (V,) f32 snapped screen x per vertex
    sy: torch.Tensor  # (V,) f32 snapped screen y
    w: torch.Tensor  # (V,) f32 clip w
    tri_vidx: torch.Tensor  # (T, 3) i64
    coefs: torch.Tensor  # (T, 3, 4) f32 rows a, b, c of planes e0, e1, e2, z
    top_left: torch.Tensor  # (T, 3) bool fill-rule flags of the three edges
    table: torch.Tensor  # (NB, n_chunks * chunk) i64 candidates, -1 = none
    near_culled: torch.Tensor
    bin_overflow: torch.Tensor
    grid: _BinGrid


def _bin(positions, tile_mask, view_proj, width: int, height: int, bin_px: int, bin_cap: int,
         chunk: int, cull_backfaces: bool, near_eps: float) -> _Binned:
    """Setup and binning: projection, culling, the per-triangle plane
    coefficients (:func:`_bin_pairs`), the sort of the bin pairs
    (:func:`_sort_pairs`) and the candidate table (:func:`_bin_table`)."""
    p = _bin_pairs(positions, tile_mask, view_proj, width, height, bin_px, bin_cap,
                   cull_backfaces, near_eps)
    s_key, s_tri = _sort_pairs(p.key, p.znear_key, p.tri_vidx.shape[0], p.nkeys)
    return _bin_table(p, s_key, s_tri, chunk)


def _bin_pairs(positions, tile_mask, view_proj, width: int, height: int, bin_px: int,
               bin_cap: int, cull_backfaces: bool, near_eps: float) -> _Pairs:
    """Projection, culling, the per-triangle plane coefficients and each
    triangle's pyramid level and (up to 4) bin pairs."""
    dev = positions.device
    F, R, C = positions.shape[0], positions.shape[1], positions.shape[2]
    tri_vidx = _triangle_table(F, R, C, dev)  # (T, 3) i64
    T = tri_vidx.shape[0]

    sx, sy, sz, w = _project(positions.reshape(-1, 3), view_proj, width, height)
    vx, vy = sx[tri_vidx], sy[tri_vidx]  # (T, 3) per-corner screen data
    vz, vw = sz[tri_vidx], w[tri_vidx]

    alive = tile_mask[tri_vidx[:, 0] // (R * C)]
    in_front = torch.all(vw > near_eps, dim=-1)
    near_culled = (alive & ~in_front).sum(dtype=torch.int32)

    # signed area x2 (screen space, y down -> clockwise is positive)
    area = (vx[:, 1] - vx[:, 0]) * (vy[:, 2] - vy[:, 0]) - (
        vy[:, 1] - vy[:, 0]) * (vx[:, 2] - vx[:, 0])
    face_ok = area > 0 if cull_backfaces else area != 0
    valid = alive & in_front & face_ok

    # --- hierarchical binning: each triangle goes to the pyramid level
    # where its AABB spans <= 2x2 bins, emitting exactly <= 4 pairs ---
    g = _bin_grid(width, height, bin_px, bin_cap, dev)
    NB = g.nbx * g.nby
    nkeys = int(g.key_off[-1])
    minx, maxx = vx.amin(-1), vx.amax(-1)
    miny, maxy = vy.amin(-1), vy.amax(-1)
    offscreen = (maxx < 0) | (minx >= width) | (maxy < 0) | (miny >= height)
    valid = valid & ~offscreen

    def pixel(v, size):  # floor, clamped to the image (in f32: no int overflow)
        return torch.floor(v).clamp(0, size - 1).to(torch.int32)

    # level-0 bin index span; level L covers it with <= 2x2 bins iff
    # max(dx, dy) <= 2^L, so the level is ceil(log2(max(d, 1))) clipped
    cbx0, cbx1 = pixel(minx, width) // bin_px, pixel(maxx, width) // bin_px
    cby0, cby1 = pixel(miny, height) // bin_px, pixel(maxy, height) // bin_px
    d = torch.maximum(cbx1 - cbx0, cby1 - cby0)
    lvl = torch.zeros_like(d)
    for L in range(1, g.levels):  # ceil(log2(d)) >= L  <=>  d > 2^(L-1)
        lvl += (d > (1 << (L - 1))).to(torch.int32)
    bx0, bx1 = cbx0 >> lvl, cbx1 >> lvl
    by0, by1 = cby0 >> lvl, cby1 >> lvl
    lvl_long = lvl.long()
    lvl_nbx = g.t_nbx[lvl_long]
    lvl_off = g.t_key_off[lvl_long]

    e = torch.arange(4, dtype=torch.int32, device=dev)
    ex = torch.minimum(bx0[:, None] + (e & 1)[None, :], bx1[:, None])
    ey = torch.minimum(by0[:, None] + (e >> 1)[None, :], by1[:, None])
    dup = ((e & 1)[None, :] > (bx1 - bx0)[:, None]) | ((e >> 1)[None, :] > (by1 - by0)[:, None])
    pair_ok = valid[:, None] & ~dup
    key = torch.where(pair_ok, lvl_off[:, None] + ey * lvl_nbx[:, None] + ex, nkeys)
    # depth-prioritized binning: within a bin, near to far (reverse-Z:
    # larger z = nearer), so a bin over its cap drops the farthest. Positive
    # IEEE floats order like their bit patterns: the negated bitcast is an
    # ascending near-first key at any depth scale
    zmax_tri = vz.amax(-1).clamp(min=0.0)
    znear_key = -zmax_tri.view(torch.int32)

    # per-triangle plane coefficients, normalized by sign(area) so that
    # inside = all E >= 0 regardless of winding ---
    x0, x1, x2 = vx.unbind(-1)
    y0, y1, y2 = vy.unbind(-1)
    z0, z1, z2 = vz.unbind(-1)
    a0, b0, c0 = edge_coef(x1, y1, x2, y2)
    a1, b1, c1 = edge_coef(x2, y2, x0, y0)
    a2, b2, c2 = edge_coef(x0, y0, x1, y1)
    ar = a0 * x0 + b0 * y0 + c0  # = 2*area
    s = torch.where(ar < 0, -1.0, 1.0)
    inv_ar = s / torch.clamp(ar.abs(), min=1e-20)
    # depth is screen-affine: z(x,y) = sum_i bary_i(x,y) * z_i
    za = (a0 * z0 + a1 * z1 + a2 * z2) * inv_ar
    zb = (b0 * z0 + b1 * z1 + b2 * z2) * inv_ar
    zc = (c0 * z0 + c1 * z1 + c2 * z2) * inv_ar
    # (T, 3 coefficients, 4 planes): rows a, b, c; planes e0, e1, e2, z
    coefs = torch.stack([
        torch.stack([a0 * s, a1 * s, a2 * s, za], -1),
        torch.stack([b0 * s, b1 * s, b2 * s, zb], -1),
        torch.stack([c0 * s, c1 * s, c2 * s, zc], -1),
    ], dim=1)
    # fill rule on the sign-normalized edge (a, b): E == 0 counts when
    # (b < 0) or (b == 0 and a > 0); the two triangles on a shared edge see
    # opposite signs, so exactly one takes the boundary pixels
    top_left = (coefs[:, 1, :3] < 0) | ((coefs[:, 1, :3] == 0) & (coefs[:, 0, :3] > 0))
    return _Pairs(sx, sy, w, tri_vidx, coefs, top_left, key, znear_key[:, None].expand(T, 4),
                  nkeys, near_culled, g)


def _bin_table(p: _Pairs, s_key, s_tri, chunk: int) -> _Binned:
    """The candidate table from the sorted pairs: each pair's rank in its
    (level, bin), the per-level tables filled by one scatter (the pairs
    past a level's cap dropped and counted) and gathered onto the level-0
    bins, in chunks of ``chunk``."""
    g, nkeys, dev = p.grid, p.nkeys, s_key.device
    NB = g.nbx * g.nby

    # rank within (level, bin): i - first index of this key's segment. The
    # keys are sorted and few (one per bin of the pyramid), so each key's
    # first index is one binary search; the JAX package's running max over
    # segment starts (torch.cummax) gives the same ranks, but cummax is one
    # slow scan kernel on the card (31 ms of 10.6 M pairs on an H100)
    n_pairs = s_key.shape[0]
    idx = torch.arange(n_pairs, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(s_key, torch.arange(nkeys + 1, dtype=torch.int64, device=dev))
    rank = idx - starts[s_key]

    # dense per-level tables from ONE scatter, gathered back onto the
    # level-0 grid and concatenated into one (NB, sum(caps)) candidate table.
    # Dropped pairs go to slots of their own past the table (no duplicate
    # index, so the scatter is deterministic on the card too)
    total_tab = int(g.table_base[-1])
    lvl_e = torch.zeros_like(s_key)
    for L in range(1, g.levels):
        lvl_e += (s_key >= int(g.key_off[L])).to(torch.int64)
    cap_e = g.t_caps[lvl_e]
    real = s_key < nkeys
    keep = real & (rank < cap_e)
    bin_overflow = (real & (rank >= cap_e)).sum(dtype=torch.int32)
    off_e = g.t_key_off[lvl_e].to(torch.int64)
    gslot = torch.where(keep, g.t_table_base[lvl_e] + (s_key - off_e) * cap_e + rank,
                        total_tab + idx)
    flat_tab = torch.full((total_tab + n_pairs,), -1, dtype=torch.int64, device=dev)
    flat_tab[gslot] = s_tri
    tables = []
    for L in range(g.levels):
        base = int(g.table_base[L])
        tab = flat_tab[base:base + g.nb_l[L] * g.caps[L]].view(g.nb_l[L], g.caps[L])
        tables.append(tab[g.ups[L]])
    total_cap = int(sum(g.caps))
    n_chunks = -(-total_cap // chunk)
    tables.append(torch.full((NB, n_chunks * chunk - total_cap), -1, dtype=torch.int64,
                             device=dev))
    table = torch.cat(tables, dim=1)  # (NB, n_chunks * chunk)
    return _Binned(p.sx, p.sy, p.w, p.tri_vidx, p.coefs, p.top_left, table, p.near_culled,
                   bin_overflow, g)


def _scan(b: _Binned, bin_px: int, chunk: int):
    """The raster scan: a running (depth, triangle) max per pixel over the
    candidate chunks. Returns (best z, best triangle) per bin pixel."""
    g, table, coefs = b.grid, b.table, b.coefs
    NB, dev = table.shape[0], table.device
    n_chunks = table.shape[1] // chunk
    P = bin_px * bin_px
    best_z = torch.full((NB, P), -torch.inf, dtype=torch.float32, device=dev)
    best_t = torch.full((NB, P), -1, dtype=torch.int64, device=dev)
    for c_idx in range(n_chunks):
        cand = table[:, c_idx * chunk:(c_idx + 1) * chunk]  # (NB, C)
        safe = cand.clamp(min=0)
        cf = coefs[safe]  # (NB, C, 3, 4)
        planes = (cf[:, None, :, 0] * g.pix_x[..., None] + cf[:, None, :, 1] * g.pix_y[..., None]
                  ) + cf[:, None, :, 2]  # (NB, P, C, 4)
        edges = planes[..., :3]
        inside = torch.where(b.top_left[safe][:, None], edges >= 0, edges > 0).all(-1)
        inside &= (cand >= 0)[:, None, :]
        z = torch.where(inside, planes[..., 3], -torch.inf)
        zmax, zi = z.max(dim=-1)  # the first maximum wins
        better = zmax > best_z
        best_z = torch.where(better, zmax, best_z)
        best_t = torch.where(better, torch.gather(cand, 1, zi), best_t)

    return best_z, best_t


def _resolve(b: _Binned, best_z, best_t, width: int, height: int, bin_px: int) -> RasterOutput:
    """The winners' images and their perspective-correct barycentrics."""
    g, sx, sy, w = b.grid, b.sx, b.sy, b.w
    def to_image(binned):
        img = binned.reshape(g.nby, g.nbx, bin_px, bin_px)
        img = img.permute(0, 2, 1, 3).reshape(g.nby * bin_px, g.nbx * bin_px)
        return img[:height, :width]

    depth_img = to_image(best_z)
    tri_img = to_image(best_t)
    covered_img = tri_img >= 0

    # perspective-correct barycentrics of the winner
    vids = b.tri_vidx[tri_img.clamp(min=0)]  # (H, W, 3)
    rx, ry, rw = sx[vids], sy[vids], w[vids]
    pxc, pyc = _pixel_centres(width, height, best_z.device)

    def edge_at(i, j):
        return (rx[..., j] - rx[..., i]) * (pyc - ry[..., i]) - (
            ry[..., j] - ry[..., i]) * (pxc - rx[..., i])

    eb0 = edge_at(1, 2)
    eb1 = edge_at(2, 0)
    eb2 = edge_at(0, 1)
    denom = eb0 + eb1 + eb2
    denom = torch.where(denom.abs() < 1e-20, 1e-20, denom)
    lin = torch.stack([eb0, eb1, eb2], dim=-1) / denom[..., None]
    pc = lin / rw  # perspective correction: weights over w
    den = (pc[..., 0] + pc[..., 1] + pc[..., 2])[..., None]
    pc = pc / torch.where(den.abs() < 1e-20, 1e-20, den)
    bary = torch.where(covered_img[..., None], pc, 0.0)

    return RasterOutput(
        depth=torch.where(covered_img, depth_img, 0.0),
        tri_id=tri_img.to(torch.int32),
        covered=covered_img,
        bary=bary,
        vert_idx=vids.to(torch.int32),
        near_culled=b.near_culled,
        bin_overflow=b.bin_overflow,
    )


def rasterize_grid(
    positions,
    tile_mask,
    view_proj,
    width: int,
    height: int,
    bin_px: int = 32,
    bin_cap: int = 256,
    chunk: int = 8,
    cull_backfaces: bool = False,
    near_eps: float = 1e-4,
) -> RasterOutput:
    """Rasterize (F, G1, G1, 3) world-space vertex grids to (H, W) buffers.

    The per-level candidate caps (``bin_cap`` at level 0, halving for
    coarser levels) are capacities whose clamping is counted, never silent
    (``bin_overflow``). ``view_proj``: (4, 4) numpy or tensor.

    Sizing ``bin_cap``: UDLOD emits roughly one vertex per output pixel at
    the view's design resolution, so expect about ``2 * bin_px^2 *
    (design_px / (W * H))`` triangles per level-0 bin on average; give
    hotspots ~4x headroom, and treat ``bin_overflow > 0`` as the signal.

    The three phases run inside ``torch.profiler.record_function`` ranges
    (``raster::bin_sort``, ``raster::scan``, ``raster::resolve``).
    """
    with torch.profiler.record_function("raster::bin_sort"):
        b = _bin(positions, tile_mask, view_proj, width, height, bin_px, bin_cap, chunk,
                 cull_backfaces, near_eps)
    with torch.profiler.record_function("raster::scan"):
        best_z, best_t = _scan(b, bin_px, chunk)
    with torch.profiler.record_function("raster::resolve"):
        return _resolve(b, best_z, best_t, width, height, bin_px)


def _skirt_vertex_map(F: int, G1: int) -> np.ndarray:
    """Flat vertex remap from the skirted (G1+2)^2 grids back to the
    original G1^2 grids: ring vertices map to their nearest boundary
    vertex, so attribute interpolation stretches edge values down the
    skirt (the standard terrain-skirt look)."""
    S = G1 + 2
    rr = np.clip(np.arange(S) - 1, 0, G1 - 1)
    inner = (rr[:, None] * G1 + rr[None, :])[None]  # (1, S, S)
    base = (np.arange(F) * (G1 * G1)).reshape(F, 1, 1)
    return (base + inner).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _skirt_table(F: int, G1: int, device: torch.device) -> torch.Tensor:
    return _to_device(_skirt_vertex_map(F, G1).astype(np.int64), device)


def add_skirts(positions, depth_frac: float = 0.05, spherical: bool = False):
    """(F, G1, G1, 3) -> (F, G1+2, G1+2, 3): pad each tile with a ring of
    boundary-vertex copies displaced downward by ``depth_frac`` of the
    tile's world edge length.

    Skirts close the sub-pixel seams that remain when adjacent tiles'
    boundary heights differ inside the engine's documented envelope (the
    per-tile vertex-density mip selection; the cross-lod morph tolerance).
    Pure geometry: attribute interpolation uses :func:`_skirt_vertex_map`.
    """
    G1 = positions.shape[1]
    S = G1 + 2
    rr = torch.arange(S, device=positions.device).sub(1).clamp(0, G1 - 1)
    padded = positions[:, rr][:, :, rr]  # edge padding
    if spherical:
        down = -padded / torch.clamp(torch.linalg.vector_norm(padded, dim=-1, keepdim=True),
                                      min=1e-8)
    else:
        down = torch.zeros(3, dtype=positions.dtype, device=positions.device)
        down[1] = -1.0
    edge_len = torch.linalg.vector_norm(positions[:, 0, -1, :] - positions[:, 0, 0, :], dim=-1)
    depth = (depth_frac * edge_len)[:, None, None, None]
    ring = torch.arange(S, device=positions.device)
    ring = (ring == 0) | (ring == S - 1)
    rim = (ring[:, None] | ring[None, :]).to(positions.dtype)[None, :, :, None]
    return padded + down * depth * rim


def _grid_mesh(mesh):
    if not isinstance(mesh, GridMeshOutput):
        raise TypeError(f"the rasterizer takes a GridMeshOutput (the fused and the staged "
                        f"path's mesh), not {type(mesh).__name__}")
    return mesh


def render_view(
    mesh,
    tiles,
    uniforms,
    cfg,
    view_proj,
    width: int,
    height: int,
    material=None,
    lighting: bool = True,
    debug_view: Optional[str] = None,
    shade_mode: str = "pixel",
    attachment_samples: Optional[dict] = None,
    texture_size: int = 512,
    background=(0.0, 0.0, 0.0, 0.0),
    skirts: bool = True,
    pixel_attachment: Optional[tuple] = None,
    **raster_knobs,
):
    """Rasterize one terrain view to an (H, W, 4) image on the mesh's
    device.

    ``shade_mode="pixel"`` is the reference's shading rate
    (fragment.wgsl:95-113): the material's base colour and the shading
    normal are interpolated perspective-correct per pixel and
    :func:`~render.material.pbr_lighting` runs on the pixel maps (Phong
    shading). ``shade_mode="vertex"`` lights per vertex and interpolates the
    lit colour (Gouraud); debug views take that path too.

    ``skirts=True`` rasterizes each tile with a downward edge skirt
    (:func:`add_skirts`). ``pixel_attachment=(slabs, scale, offset,
    max_value, tex_size)`` switches the base colour to per-pixel deferred
    texturing (:func:`sample_attachment_pixel`, the reference's
    textureSampleGrad filtering).

    Returns ``(image, RasterOutput)``.
    """
    from bevy_terrain_tpu_torch.render import material as mat

    mesh = _grid_mesh(mesh)
    if skirts:
        pos_in = add_skirts(mesh.positions, spherical=cfg.spherical)
        raster = rasterize_grid(pos_in, mesh.tile_mask, view_proj, width, height,
                                **raster_knobs)
        F, G1 = mesh.positions.shape[0], mesh.positions.shape[1]
        vmap = _skirt_table(F, G1, mesh.positions.device)
        raster = raster._replace(vert_idx=vmap[raster.vert_idx.long()].to(torch.int32))
    else:
        raster = rasterize_grid(mesh.positions, mesh.tile_mask, view_proj, width, height,
                                **raster_knobs)
    bg = _f32_on(np.asarray(background, np.float32), mesh.positions.device)

    if debug_view is not None or shade_mode == "vertex":
        colors_v = mat.shade(
            mesh, tiles, uniforms, cfg, material=material, lighting=lighting,
            debug_view=debug_view, texture_size=texture_size,
            attachment_samples=attachment_samples,
        )
        img = interpolate(raster, colors_v, background=0.0)
        return torch.where(raster.covered[..., None], img, bg), raster

    # per-pixel PBR: interpolate base colour, shading normal, position
    normals_v = mat.surface_normals_from_heights(mesh, tiles, uniforms, cfg)
    ctx = mat.ShadeContext(mesh=mesh, tiles=tiles, normals=normals_v, uniforms=uniforms,
                           cfg=cfg, texture_size=texture_size,
                           attachment_samples=attachment_samples)
    if pixel_attachment is not None:
        slabs, a_scale, a_offset, a_maxv, a_tex = pixel_attachment
        base_p = sample_attachment_pixel(
            raster, mesh, tiles, uniforms, cfg, slabs, a_scale, a_offset, a_maxv, a_tex,
            view_proj=view_proj, width=width, height=height,
        )
        if base_p.shape[-1] < 4:
            base_p = torch.cat([base_p] + [torch.ones_like(base_p[..., :1])]
                               * (4 - base_p.shape[-1]), dim=-1)
    else:
        base_p = interpolate(raster, (material or mat.default_color)(ctx))
    n_p = interpolate(raster, normals_v)
    n_p = n_p / torch.clamp(torch.linalg.vector_norm(n_p, dim=-1, keepdim=True), min=1e-8)
    pos_p = interpolate(raster, mesh.positions)
    if lighting:
        params = {}
        if isinstance(material, mat.StandardMaterial):
            params = dict(perceptual_roughness=material.perceptual_roughness,
                          metallic=material.metallic, reflectance=material.reflectance,
                          emissive=material.emissive, lights=material.lights,
                          ambient=material.ambient)
        img = mat.pbr_lighting(base_p, n_p, pos_p, uniforms.view_world_position, **params)
    else:
        img = base_p
    return torch.where(raster.covered[..., None], img, bg), raster


def pixel_uv_and_grads(raster: RasterOutput, mesh, view_proj, width, height):
    """Per-pixel morphed tile uv + ANALYTIC screen-space derivatives.

    The reference's fragment stage gets duv/dx, duv/dy from the GPU's quad
    derivatives and feeds textureSampleGrad (fragment.wgsl:35-49,
    attachments.wgsl:12-24). Here the winning triangle's projective
    interpolation u(x, y) = N/D (N = sum u_i L_i / w_i, D = sum L_i / w_i
    over the affine barycentrics L_i) has a closed-form gradient (dL_i/dx =
    a_i / 2A, constant per triangle), so the derivatives are exact per
    pixel. Returns (uv, duv_dx, duv_dy), each (H, W, 2), zero outside
    coverage.
    """
    flat_uv = mesh.uvs.reshape(-1, 2)
    sx, sy, _, w = _project(mesh.positions.reshape(-1, 3), view_proj, width, height)
    vids = raster.vert_idx.long()  # (H, W, 3)
    uv3 = flat_uv[vids]  # (H, W, 3, 2)
    x3, y3, w3 = sx[vids], sy[vids], w[vids]
    pxc, pyc = _pixel_centres(width, height, mesh.positions.device)

    # affine barycentric L_i via the edge opposite vertex i (cyclic)
    def edge(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        e = (x3[..., k] - x3[..., j]) * (pyc - y3[..., j]) - (
            y3[..., k] - y3[..., j]) * (pxc - x3[..., j])
        return e, -(y3[..., k] - y3[..., j]), x3[..., k] - x3[..., j]

    e0, a0, b0 = edge(0)
    e1, a1, b1 = edge(1)
    e2, a2, b2 = edge(2)
    two_a = e0 + e1 + e2  # constant per triangle
    two_a = torch.where(two_a.abs() < 1e-20, 1e-20, two_a)[..., None]
    L = torch.stack([e0, e1, e2], -1) / two_a  # (H, W, 3)
    dLdx = torch.stack([a0, a1, a2], -1) / two_a
    dLdy = torch.stack([b0, b1, b2], -1) / two_a

    def sum3(v):  # over the corner axis -2 of (..., 3, k), in one order
        return v[..., 0, :] + v[..., 1, :] + v[..., 2, :]

    inv_w = 1.0 / torch.where(w3.abs() < 1e-12, 1e-12, w3)  # (H, W, 3)
    D = sum3((L * inv_w)[..., None])
    D = torch.where(D.abs() < 1e-20, 1e-20, D)
    N = sum3(uv3 * (L * inv_w)[..., None])  # (H, W, 2)
    uv = N / D
    dDdx = sum3((dLdx * inv_w)[..., None])
    dDdy = sum3((dLdy * inv_w)[..., None])
    dNdx = sum3(uv3 * (dLdx * inv_w)[..., None])
    dNdy = sum3(uv3 * (dLdy * inv_w)[..., None])
    duv_dx = (dNdx - uv * dDdx) / D
    duv_dy = (dNdy - uv * dDdy) / D
    m = raster.covered[..., None]
    return (torch.where(m, uv, 0.0), torch.where(m, duv_dx, 0.0),
            torch.where(m, duv_dy, 0.0))


def sample_attachment_pixel(
    raster: RasterOutput,
    mesh,
    tiles,
    uniforms,
    cfg,
    slabs,
    scale: float,
    offset: float,
    max_value: float,
    texture_size: int,
    view_proj=None,
    width: int | None = None,
    height: int | None = None,
):
    """Per-pixel attachment sampling with screen-derivative mip selection:
    the reference's per-fragment path (fragment.wgsl:35-49 tile lookup +
    attachments.wgsl textureSampleGrad), pixel for pixel on the rasterized
    frame.

    Per pixel: interpolate the morphed tile uv, look up the best loaded
    atlas tile (the lookup_best / lookup_tile chain of the per-vertex
    shader), convert the analytic uv gradients into atlas texel units, pick
    the fractional mip, and trilinear-sample the slab chain. Returns (H, W,
    C) f32 in [0, 1], zero outside coverage.
    """
    from bevy_terrain_tpu_torch.ops import coords, sampling

    G1 = mesh.positions.shape[1]
    if view_proj is not None:
        uv, ddx, ddy = pixel_uv_and_grads(raster, mesh, view_proj, width, height)
    else:
        uv = interpolate(raster, mesh.uvs)
        ddx = ddy = None

    f = raster.vert_idx[..., 0].long() // (G1 * G1)  # (H, W) tile lane
    F = cfg.tile_capacity
    side = tiles.tile_side[:F][f]
    lodt = tiles.tile_lod[:F].clamp(min=0)[f]
    xy = tiles.tile_xy[:F][f]

    pos_p = interpolate(raster, mesh.positions)
    view_distance = torch.linalg.vector_norm(pos_p - uniforms.view_world_position, dim=-1)
    blend_lod, _ = coords.compute_blend(view_distance, uniforms, cfg)
    if cfg.tile_tree_lod:
        atlas_index, a_lod, _, a_uv = coords.lookup_best(
            uniforms.entries, uniforms.origins, side, lodt, xy, uv, cfg)
    else:
        atlas_index, a_lod, _, a_uv = coords.lookup_tile(
            uniforms.entries, side, lodt, xy, uv, blend_lod, cfg)
    atlas_index = torch.where(raster.covered, atlas_index, -1)

    uv_in = sampling.attachment_uv(a_uv, scale, offset)
    if ddx is None:
        return sampling.sample_bilinear(slabs[0], atlas_index, uv_in, max_value)
    # tile-uv -> atlas-texel gradient scale: the atlas tile at a_lod spans
    # 2^(lodt - a_lod) geometry tiles, then border inset + texels
    gscale = torch.exp2((a_lod - lodt).to(torch.float32))[..., None]
    texel_dx = ddx * gscale * scale * texture_size
    texel_dy = ddy * gscale * scale * texture_size
    mip = sampling.mip_level_from_grad(texel_dx, texel_dy, 1)
    return sampling.sample_trilinear(slabs, atlas_index, uv_in, mip, max_value)


def interpolate(raster: RasterOutput, vertex_values, background=0.0):
    """Perspective-correct per-pixel interpolation of per-vertex values.

    ``vertex_values``: (F, G1, G1, C) or (F, G1, G1) -> (H, W, C)/(H, W).
    """
    scalar = vertex_values.dim() == 3
    flat = vertex_values.reshape((-1, 1) if scalar else (-1, vertex_values.shape[-1]))
    tri = flat[raster.vert_idx.long()]  # (H, W, 3, C)
    bary = raster.bary[..., None]
    out = tri[..., 0, :] * bary[..., 0, :] + tri[..., 1, :] * bary[..., 1, :] + (
        tri[..., 2, :] * bary[..., 2, :])
    out = torch.where(raster.covered[..., None], out, background)
    return out[..., 0] if scalar else out
