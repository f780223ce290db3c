"""Rasterizer fixtures and the numpy scanline oracle, with no jax.

Shared by tests/test_torch_raster.py (the port against the JAX package on
the CPU) and tests/test_torch_cuda.py (the port on the card against the
CPU, where jax is not installed). The oracle is a copy of
tests/test_raster.py::oracle_raster: a scalar rasterizer with the same
contract (pixel centres at +0.5, sign-normalized edge functions, the
top-left fill rule, reverse-Z depth max) in float64.
"""

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.frustum import view_projection
from bevy_terrain_tpu_torch.render import raster
from bevy_terrain_tpu_torch.render.raster import _triangle_vertex_indices


def _project_np(positions, vp, width, height):
    p = positions.reshape(-1, 3).astype(np.float64)
    clip = p @ np.asarray(vp)[:, :3].T + np.asarray(vp)[:, 3]
    w = clip[:, 3]
    ndc = clip[:, :3] / w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    return sx, sy, ndc[:, 2], w


def oracle_raster(positions, tile_mask, vp, width, height, near_eps=1e-4):
    """Scalar reference rasterizer; returns (tri_id, depth, edge_margin),
    the margin being the winner's least normalized edge value (px)."""
    F, G1 = positions.shape[0], positions.shape[1]
    tri_vidx = _triangle_vertex_indices(F, G1)
    sx, sy, sz, w = _project_np(positions, vp, width, height)
    tri_img = np.full((height, width), -1, np.int64)
    depth = np.full((height, width), -np.inf)
    margin = np.full((height, width), np.inf)

    for t, vid in enumerate(tri_vidx):
        if not tile_mask[vid[0] // (G1 * G1)] or np.any(w[vid] <= near_eps):
            continue
        x, y, z = sx[vid], sy[vid], sz[vid]
        area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
        if area == 0:
            continue
        s = -1.0 if area < 0 else 1.0
        x0, x1 = int(np.floor(x.min())), int(np.ceil(x.max()))
        y0, y1 = int(np.floor(y.min())), int(np.ceil(y.max()))
        for py in range(max(y0, 0), min(y1 + 1, height)):
            for px in range(max(x0, 0), min(x1 + 1, width)):
                cx, cy = px + 0.5, py + 0.5
                es = []
                for i in range(3):
                    j, k = (i + 1) % 3, (i + 2) % 3
                    a = -(y[k] - y[j]) * s
                    b = (x[k] - x[j]) * s
                    e = ((x[k] - x[j]) * (cy - y[j]) - (y[k] - y[j]) * (cx - x[j])) * s
                    tl = (b < 0) or (b == 0 and a > 0)
                    if not (e > 0 or (e == 0 and tl)):
                        break
                    es.append(e)
                else:
                    zval = float(np.array(es) / abs(area) @ z)
                    if zval > depth[py, px]:
                        depth[py, px] = zval
                        tri_img[py, px] = t
                        margin[py, px] = min(es) / abs(area)
    return tri_img, depth, margin


def flat_tile(G1=3, size=10.0, y=0.0):
    xs = np.linspace(-size / 2, size / 2, G1)
    gx, gz = np.meshgrid(xs, xs, indexing="xy")
    return np.stack([gx, np.full_like(gx, y), gz], -1)[None].astype(np.float32)


def _vp(eye, target, fov_deg, near=0.1):
    return view_projection(eye=eye, target=target, fov_y=np.radians(fov_deg), aspect=1.0,
                           near=near).astype(np.float32)


VP_TOPDOWN = _vp([0.0, 20.0, 0.01], [0.0, 0.0, 0.0], 60.0)


def _bumpy(seed, G1, amplitude, size=10.0):
    pos = flat_tile(G1=G1, size=size)
    pos[..., 1] += np.random.default_rng(seed).uniform(0, amplitude, pos[..., 1].shape).astype(
        np.float32)
    return pos


def _seam():
    """Two abutting bumpy tiles (tests/test_raster.py's oracle fixture)."""
    rng = np.random.default_rng(11)
    tiles = []
    for dx in (-5.0, 5.0):
        t = flat_tile(G1=5)
        t[..., 0] += dx
        t[..., 1] += rng.uniform(0, 4.0, t[..., 1].shape).astype(np.float32)
        tiles.append(t)
    return np.concatenate(tiles, axis=0)


def _grazing():
    """Two abutting bumpy tiles, the second one raised (a step face at the
    seam), seen from a low camera along the surface."""
    a, b = _bumpy(21, 5, 0.3), _bumpy(22, 5, 0.3)
    a[..., 0] -= 5.0
    b[..., 0] += 5.0
    b[..., 1] += 0.35
    return np.concatenate([a, b], axis=0)


def raster_cases():
    """name -> (positions (F, G1, G1, 3) f32, tile mask, view_proj, width,
    height, rasterize_grid knobs): six shapes, each a distinct compile of
    the JAX function."""
    return {
        "flat": (flat_tile(), [True], VP_TOPDOWN, 64, 64, dict(bin_px=16, bin_cap=32)),
        "bumpy": (_bumpy(7, 5, 3.0), [True], VP_TOPDOWN, 96, 96, dict(bin_px=16, bin_cap=64)),
        "seam": (_seam(), [True, True], _vp([3.0, 15.0, 12.0], [0.0, 0.0, 0.0], 55.0), 80, 80,
                 dict(bin_px=16, bin_cap=128)),
        "grazing": (_grazing(), [True, True], _vp([-7.0, 1.3, 0.01], [2.0, 0.0, 0.0], 50.0),
                    96, 96, dict(bin_px=16, bin_cap=64)),
        # the camera inside the tile's footprint looking forward: part of
        # the tile lies behind it (w <= 0)
        "near": (flat_tile(), [True], _vp([0.0, 1.0, 0.0], [0.0, 0.0, 10.0], 60.0), 64, 64,
                 dict(bin_px=16, bin_cap=64)),
        # one bin holds the whole image; 128 triangles against a cap of 8
        "overflow": (_bumpy(3, 9, 1.0), [True], VP_TOPDOWN, 64, 64,
                     dict(bin_px=64, bin_cap=8, chunk=8)),
    }


def binned_case(name, device="cpu"):
    """A raster case binned on ``device``: (``raster._bin``'s products,
    ``rasterize_grid``'s positional arguments, its knobs with the defaults
    filled in). Case "nan" is "seam" with NaN coefficients on live
    candidates: the depth plane of every 7th (a NaN depth wins its column
    group in torch.max, never the running best; in "seam" it shares a group
    with a covering triangle on some pixels), an edge of every 11th from
    the 4th (never inside)."""
    pos, mask, vp, W, H, knobs = raster_cases()["seam" if name == "nan" else name]
    k = dict(dict(bin_px=32, bin_cap=256, chunk=8), **knobs)
    args = (torch.from_numpy(pos).to(device), torch.tensor(mask, device=device),
            torch.from_numpy(vp).to(device), W, H)
    b = raster._bin(*args, k["bin_px"], k["bin_cap"], k["chunk"], False, 1e-4)
    if name == "nan":
        live = torch.unique(b.table[b.table >= 0])
        coefs = b.coefs.clone()
        coefs[live[::7], 2, 3] = float("nan")
        coefs[live[3::11], 0, 1] = float("nan")
        b = b._replace(coefs=coefs)
    return b, args, k


def decisive(o_tri, o_margin):
    """Pixels where the oracle's answer is decisive: uncovered, or covered
    more than 1e-3 px inside the winner (tests/test_raster.py:592-596;
    f32 and f64 edge evaluations may disagree within ~1e-4 of an edge)."""
    return (o_margin > 1e-3) | (o_tri < 0)


def screen_vp(width, height):
    """A view-projection that maps world (x, y) to screen (x, y) exactly at
    w = 1 and depth 0.5 (x, y multiples of 1/2 below 64)."""
    return np.array([[2.0 / width, 0.0, 0.0, -1.0],
                     [0.0, -2.0 / height, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 0.5],
                     [0.0, 0.0, 0.0, 1.0]], np.float32)


def single_triangle_tiles(seed=0, cells=6, spacing=8.0, origin=4.5):
    """A jittered grid of screen points triangulated with random diagonals
    and random windings, one triangle per (2, 2) tile: corners (v00, v01,
    v10) are the triangle and v11 = v01 makes the tile's second triangle
    degenerate (culled). Points sit on pixel centres and half-pixel steps,
    so many edges pass exactly through pixel centres. Returns (positions
    (N, 2, 2, 3), the rectangle (x0, y0, x1, y1) the triangles tile)."""
    rng = np.random.default_rng(seed)
    n = cells + 1
    gx = origin + spacing * np.arange(n)
    px = np.broadcast_to(gx[None, :], (n, n)).copy()
    py = np.broadcast_to(gx[:, None], (n, n)).copy()
    jit = rng.integers(-3, 4, (2, n - 2, n - 2)) * 0.5  # interior points only
    px[1:-1, 1:-1] += jit[0]
    py[1:-1, 1:-1] += jit[1]
    tris = []
    for r in range(cells):
        for c in range(cells):
            p00, p01 = (px[r, c], py[r, c]), (px[r, c + 1], py[r, c + 1])
            p10, p11 = (px[r + 1, c], py[r + 1, c]), (px[r + 1, c + 1], py[r + 1, c + 1])
            pair = ([p00, p01, p10], [p10, p01, p11]) if rng.random() < 0.5 else (
                [p00, p01, p11], [p00, p11, p10])
            for tri in pair:
                order = rng.permutation(3)
                tris.append([tri[i] for i in order])
    pos = np.zeros((len(tris), 2, 2, 3), np.float32)
    for f, (a, b, c) in enumerate(tris):
        pos[f, 0, 0, :2], pos[f, 0, 1, :2], pos[f, 1, 0, :2] = a, b, c
        pos[f, 1, 1, :2] = b
    return pos, (gx[0], gx[0], gx[-1], gx[-1])
