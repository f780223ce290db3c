"""The terrain's geometry in float64: the planar and cube-sphere surfaces,
the view coordinate on each cube face, the camera matrices and their
frustum planes, and the view's distance rules (CDLOD morph and blend).

Written from the semantics of bevy_terrain (``src/math/coordinate.rs``,
``src/math/terrain_model.rs``, ``src/shaders/functions.wgsl``,
``src/terrain_view.rs``), not from the program: a coordinate is a cube
face (``side``) and a position ``(s, t)`` in [0, 1]^2 on it; a tile at
``lod`` covers ``[x, x + 1] / 2^lod`` by ``[y, y + 1] / 2^lod``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the cube-sphere warp that evens out texel areas (coordinate.rs)
C_SQR = 0.87 * 0.87

# cube position of a face point (p, q): SIDE[side] @ (p, q, 1)
# side 0: (-1, -q, p)  1: (p, -q, 1)  2: (p, 1, q)  3: (1, -p, q)  4: (q, -p, -1)
# side 5: (q, -1, p)
SIDE = np.array([
    [[0, 0, -1], [0, -1, 0], [1, 0, 0]],
    [[1, 0, 0], [0, -1, 0], [0, 0, 1]],
    [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
    [[0, 0, 1], [-1, 0, 0], [0, 1, 0]],
    [[0, 1, 0], [-1, 0, 0], [0, 0, -1]],
    [[0, 1, 0], [0, 0, -1], [1, 0, 0]],
], np.float64)

# the face "up" of each side's tangent frame (attachments.wgsl)
FACE_UP = np.array([[0, 1, 0], [0, 1, 0], [0, 0, -1], [0, 0, -1], [-1, 0, 0], [-1, 0, 0]],
                   np.float64)

# where a coordinate of one face lies on another (coordinate.rs): per
# (6 + other - side) % 6, the (u, v) of the projection as 0, 1, s or t
_F0, _F1, _S, _T = 0, 1, 2, 3
_EVEN = [(_S, _T), (_F0, _T), (_F0, _S), (_T, _S), (_T, _F0), (_S, _F0)]
_ODD = [(_S, _T), (_S, _F1), (_T, _F1), (_T, _S), (_F1, _S), (_F1, _T)]


def view_settings(cfg: dict) -> dict:
    """The view's distances in metres and its ranges (``cfg["view"]``,
    bevy_terrain's TerrainViewConfig; distances are multiples of the
    model's scale: half the side of a plane, the radius of a sphere)."""
    v, m = cfg["view"], cfg["model"]
    scale = m["side_m"] / 2.0 if m["kind"] == "planar" else m["radius_m"]
    return {
        "scale": scale,
        "morph_distance": v["morph_distance"] * scale,
        "blend_distance": v["blend_distance"] * scale,
        "subdivision_distance": v["morph_distance"] * scale * (1.0 + v["subdivision_tolerance"]),
        "morph_range": v["morph_range"], "blend_range": v["blend_range"],
        "refinement_count": v["refinement_count"],
        "lod_count": cfg["lod_count"], "data_lods": cfg["data_lod_count"],
        "grid": v["grid_size"], "culling": v["culling"],
        "min_h": m["min_height_m"], "max_h": m["max_height_m"],
        "spherical": m["kind"] != "planar", "sides": 1 if m["kind"] == "planar" else 6,
        "side_m": m.get("side_m"), "radius_m": m.get("radius_m"),
    }


def surface(vs: dict, side, s, t):
    """World position at height 0 and unit up of face coordinates (s, t),
    tensors of one shape; returns ((..., 3), (..., 3)) float64."""
    s, t = s.to(torch.float64), t.to(torch.float64)
    if not vs["spherical"]:
        pos = torch.stack([(s - 0.5) * vs["side_m"], torch.zeros_like(s),
                           (t - 0.5) * vs["side_m"]], dim=-1)
        up = torch.zeros_like(pos)
        up[..., 1] = 1.0
        return pos, up
    w = torch.stack([2.0 * s - 1.0, 2.0 * t - 1.0], dim=-1)
    p = w / torch.sqrt(1.0 + C_SQR - C_SQR * w * w)
    m = torch.as_tensor(SIDE, dtype=torch.float64, device=s.device)[side.long()]
    cube = m[..., 0] * p[..., 0:1] + m[..., 1] * p[..., 1:2] + m[..., 2]
    up = cube / torch.linalg.vector_norm(cube, dim=-1, keepdim=True)
    return up * vs["radius_m"], up


def _own_face(eye: np.ndarray) -> tuple:
    """(side, (s, t)) of the direction of ``eye`` on the face it crosses."""
    n = eye / np.linalg.norm(eye)
    x, y, z = n
    ax, ay, az = abs(x), abs(y), abs(z)
    if ax > ay and ax > az:
        side = 0 if x < 0 else 3
    elif az > ay:
        side = 1 if z > 0 else 4
    else:
        side = 2 if y > 0 else 5
    raw = {0: (-z / x, y / x), 3: (-y / x, z / x), 1: (x / z, -y / z), 4: (y / z, -x / z),
           2: (x / y, z / y), 5: (-z / y, -x / y)}[side]
    raw = np.asarray(raw, np.float64)
    return side, 0.5 * raw * np.sqrt((1.0 + C_SQR) / (1.0 + C_SQR * raw * raw)) + 0.5


def eye_coordinate(vs: dict, eye: np.ndarray) -> tuple:
    """(side, (s, t)) of the point under ``eye`` on its own face."""
    if not vs["spherical"]:
        return 0, np.clip([eye[0] / vs["side_m"] + 0.5, eye[2] / vs["side_m"] + 0.5], 0.0, 1.0)
    return _own_face(np.asarray(eye, np.float64))


def view_coordinates(vs: dict, eye: np.ndarray) -> np.ndarray:
    """(sides, 2) the point under ``eye`` on each face: its own face's
    coordinate, and on the others where the face's rule places it (an edge
    or a corner of the face nearest to it)."""
    side, st = eye_coordinate(vs, eye)
    if not vs["spherical"]:
        return np.asarray(st, np.float64)[None]
    out = np.zeros((6, 2))
    for other in range(6):
        code = (_EVEN if side % 2 == 0 else _ODD)[(6 + other - side) % 6]
        out[other] = [{_F0: 0.0, _F1: 1.0, _S: st[0], _T: st[1]}[c] for c in code]
    return out


def ground(vs: dict, eye: np.ndarray, height: float) -> np.ndarray:
    """The point at ``height`` below (or above) ``eye`` on the surface's
    normal through it."""
    if not vs["spherical"]:
        return np.array([eye[0], height, eye[2]], np.float64)
    n = eye / np.linalg.norm(eye)
    return n * (vs["radius_m"] + height)


def blend(vs: dict, d):
    """(lod, ratio) of the data blend at view distance ``d`` (tensor): lod
    = floor(log2(blend_distance / d)) in [0, lod_count), and the share of
    the next coarser lod over its last ``blend_range`` (0 at lod 0)."""
    target = torch.clamp(torch.log2(vs["blend_distance"] / d), max=vs["lod_count"] - 1e-5)
    lod = torch.clamp(target, min=0.0).floor()
    ratio = torch.clamp((lod + vs["blend_range"] - target) / vs["blend_range"], 0.0, 1.0)
    return lod.long(), torch.where(lod == 0, torch.zeros_like(ratio), ratio)


def morph_ratio(vs: dict, lod, d):
    """The CDLOD morph toward the even grid at view distance ``d``: 1
    where log2(2 morph_distance / d) is at most the tile's lod, 0 from
    ``morph_range`` above it, none at lod 0."""
    target = torch.log2(2.0 * vs["morph_distance"] / d)
    lod_f = lod.to(torch.float64)
    ratio = torch.clamp((lod_f + vs["morph_range"] - target) / vs["morph_range"], 0.0, 1.0)
    return torch.where(lod == 0, torch.zeros_like(ratio), ratio)


def perspective(fov_y: float, aspect: float, near: float) -> np.ndarray:
    """Right-handed infinite reverse-Z projection (Bevy's camera): depth 1
    at ``near``, 0 at infinity; clip w is the distance along the view."""
    f = 1.0 / math.tan(0.5 * fov_y)
    m = np.zeros((4, 4))
    m[0, 0], m[1, 1], m[2, 3], m[3, 2] = f / aspect, f, near, -1.0
    return m


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = right, np.cross(right, fwd), -fwd
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def view_projection(eye, target, fov_y: float, aspect: float, near: float = 0.1) -> np.ndarray:
    return perspective(fov_y, aspect, near) @ look_at(eye, target)


def frustum_planes(vp: np.ndarray) -> np.ndarray:
    """(5, 4) planes [n, d], unit n, inside where n . p + d >= 0: left,
    right, bottom, top (w +- x, w +- y) and near (w - z)."""
    vp = np.asarray(vp, np.float64)
    rows = [vp[3] + vp[0], vp[3] - vp[0], vp[3] + vp[1], vp[3] - vp[1], vp[3] - vp[2]]
    p = np.stack(rows)
    return p / np.linalg.norm(p[:, :3], axis=1, keepdims=True)
