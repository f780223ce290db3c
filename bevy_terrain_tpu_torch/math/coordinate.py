"""Cube-sphere coordinates and tile coordinate algebra.

Reference: reference src/math/coordinate.rs and src/math/mod.rs:13.

The unit cube sphere uses six faces (sides 0-5). A :class:`Coordinate` is a
(side, uv) pair; uv in [0,1]^2 is warped by the algebraic sigmoid with
``C_SQR = 0.87^2`` to equalize texel area across a face
(coordinate.rs:96-97 forward, :112-114 inverse).

All formula helpers are dtype-polymorphic: they take an ``xp`` array
namespace (``numpy`` for host f64) and work on arbitrarily batched arrays;
:func:`sigmoid_warp_forward` and :func:`pick_cube_face` also take ``torch``
for f32 tensors on the device (ops/sampling.py). The host classes below wrap
the scalar case.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

# Sigmoid warp constant (reference src/math/mod.rs:13).
C_SQR = 0.87 * 0.87

# Sentinels (reference src/terrain_data/mod.rs:33-34 uses u32::MAX; we use
# int32 tensors on device, so -1 plays the role of u32::MAX).
INVALID_TILE = -1
INVALID_LOD = -1
INVALID_ATLAS_INDEX = -1

# For each side, the neighbouring side for edge index 0..4
# (0 = self, 1 = x<0, 2 = y<0, 3 = x>=n, 4 = y>=n);
# reference src/math/coordinate.rs:9-16.
NEIGHBOURING_SIDES = np.array(
    [
        [0, 4, 2, 1, 5],
        [1, 0, 2, 3, 5],
        [2, 0, 4, 3, 1],
        [3, 2, 4, 5, 1],
        [4, 2, 0, 5, 3],
        [5, 4, 0, 1, 3],
    ],
    dtype=np.int32,
)

# SideInfo codes (reference src/math/coordinate.rs:19-42).
F0, F1, PS, PT = 0, 1, 2, 3

_EVEN_LIST = np.array(
    [[PS, PT], [F0, PT], [F0, PS], [PT, PS], [PT, F0], [PS, F0]], dtype=np.int32
)
_ODD_LIST = np.array(
    [[PS, PT], [PS, F1], [PT, F1], [PT, PS], [F1, PS], [F1, PT]], dtype=np.int32
)

# PROJECT_SIDE_INFO[side, other_side] -> (info_u, info_v) codes
# (reference src/math/coordinate.rs:44-52: index = (6 + other - side) % 6,
# even sides use EVEN_LIST, odd sides ODD_LIST).
PROJECT_SIDE_INFO = np.zeros((6, 6, 2), dtype=np.int32)
for _side in range(6):
    for _other in range(6):
        _index = (6 + _other - _side) % 6
        PROJECT_SIDE_INFO[_side, _other] = (
            _EVEN_LIST[_index] if _side % 2 == 0 else _ODD_LIST[_index]
        )

# Per-side linear map from warped plane coords (p.x, p.y, 1) to the cube
# position, i.e. cube = SIDE_LOCAL_MATRICES[side] @ [p.x, p.y, 1]
# (reference src/math/coordinate.rs:115-122):
#   side 0: (-1.0, -p.y,  p.x)     side 3: ( 1.0, -p.x,  p.y)
#   side 1: ( p.x, -p.y,  1.0)     side 4: ( p.y, -p.x, -1.0)
#   side 2: ( p.x,  1.0,  p.y)     side 5: ( p.y, -1.0,  p.x)
SIDE_LOCAL_MATRICES = np.array(
    [
        [[0, 0, -1], [0, -1, 0], [1, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 1]],
        [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 1], [-1, 0, 0], [0, 1, 0]],
        [[0, 1, 0], [-1, 0, 0], [0, 0, -1]],
        [[0, 1, 0], [0, 0, -1], [1, 0, 0]],
    ],
    dtype=np.float64,
)

# Face pick for the forward mapping (local cube-sphere normal -> side + raw uv).
# uv = (dot(NUM[side,0], n), dot(NUM[side,1], n)) / dot(DEN[side], n)
# (reference src/math/coordinate.rs:76-94):
#   side 0 (x dominant, x<0):  (-z/x,  y/x)   side 3 (x>=0): (-y/x,  z/x)
#   side 1 (z dominant, z>0):  ( x/z, -y/z)   side 4 (z<0):  ( y/z, -x/z)
#   side 2 (y dominant, y>0):  ( x/y,  z/y)   side 5 (y<0):  (-z/y, -x/y)
FACE_UV_NUM = np.array(
    [
        [[0, 0, -1], [0, 1, 0]],
        [[1, 0, 0], [0, -1, 0]],
        [[1, 0, 0], [0, 0, 1]],
        [[0, -1, 0], [0, 0, 1]],
        [[0, 1, 0], [-1, 0, 0]],
        [[0, 0, -1], [-1, 0, 0]],
    ],
    dtype=np.float64,
)
FACE_UV_DEN = np.array(
    [
        [1, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
        [1, 0, 0],
        [0, 0, 1],
        [0, 1, 0],
    ],
    dtype=np.float64,
)


# ---------------------------------------------------------------------------
# dtype-polymorphic formula helpers (xp = numpy; torch where stated)
# ---------------------------------------------------------------------------


def sigmoid_warp_forward(uv, xp=np):
    """Raw cube-plane coordinate -> warped uv in [0,1] (``xp`` numpy or
    torch).

    ``w = uv * sqrt((1 + C) / (1 + C * uv^2)); uv = 0.5 w + 0.5``
    (reference src/math/coordinate.rs:96-97).
    """
    w = uv * xp.sqrt((1.0 + C_SQR) / (1.0 + C_SQR * uv * uv))
    return 0.5 * w + 0.5


def sigmoid_warp_inverse(uv, xp=np):
    """Warped uv in [0,1] -> raw cube-plane coordinate in [-1,1].

    ``w = 2 uv - 1; p = w / sqrt(1 + C - C w^2)``
    (reference src/math/coordinate.rs:112-114, src/shaders/functions.wgsl:77-78).
    """
    w = (uv - 0.5) / 0.5
    return w / xp.sqrt(1.0 + C_SQR - C_SQR * w * w)


def pick_cube_face(normal, xp=np):
    """Local unit-sphere normal(s) (..., 3) -> side index (...,) int32
    (``xp`` numpy or torch).

    Vectorized form of the branch chain in reference
    src/math/coordinate.rs:76-94.
    """
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    ax, ay, az = xp.abs(x), xp.abs(y), xp.abs(z)
    x_dom = (ax > ay) & (ax > az)
    z_dom = ~x_dom & (az > ay)
    side = xp.where(
        x_dom,
        xp.where(x < 0.0, 0, 3),
        xp.where(z_dom, xp.where(z > 0.0, 1, 4), xp.where(y > 0.0, 2, 5)),
    )
    return side.astype(np.int32) if xp is np else side.to(xp.int32)


def face_raw_uv(normal, side, xp=np):
    """Raw (pre-warp) face uv for a normal on a given side (..., 2).

    Table-driven form of reference src/math/coordinate.rs:76-94.
    """
    num = xp.asarray(FACE_UV_NUM, dtype=normal.dtype)[side]  # (..., 2, 3)
    den = xp.asarray(FACE_UV_DEN, dtype=normal.dtype)[side]  # (..., 3)
    n = normal[..., None, :]  # (..., 1, 3)
    numer = xp.sum(num * n, axis=-1)  # (..., 2)
    denom = xp.sum(den * normal, axis=-1)[..., None]  # (..., 1)
    return numer / denom


def local_position_from_side_uv(side, uv, xp=np):
    """(side, warped uv) -> unit cube-sphere local position (..., 3).

    Applies the inverse sigmoid warp and the per-side cube placement, then
    normalizes (reference src/math/coordinate.rs:110-124,
    src/shaders/functions.wgsl:73-96).
    """
    p = sigmoid_warp_inverse(uv, xp=xp)  # (..., 2)
    mats = xp.asarray(SIDE_LOCAL_MATRICES, dtype=uv.dtype)[side]  # (..., 3, 3)
    homo = xp.stack(
        [p[..., 0], p[..., 1], xp.ones_like(p[..., 0])], axis=-1
    )  # (..., 3)
    cube = xp.sum(mats * homo[..., None, :], axis=-1)  # (..., 3)
    return cube / xp.linalg.norm(cube, axis=-1, keepdims=True)


def project_uv_to_side(side, other_side, uv, xp=np):
    """Project a coordinate's uv onto another cube face.

    Chooses the closest location on the target face
    (reference src/math/coordinate.rs:134-151). ``side``/``other_side`` are
    int arrays; uv is (..., 2). Returns the projected uv (..., 2).
    """
    info = xp.asarray(PROJECT_SIDE_INFO)[side, other_side]  # (..., 2)
    candidates = xp.stack(
        [
            xp.zeros_like(uv[..., 0]),  # F0
            xp.ones_like(uv[..., 0]),  # F1
            uv[..., 0],  # PS
            uv[..., 1],  # PT
        ],
        axis=-1,
    )  # (..., 4)
    out_u = xp.take_along_axis(candidates, info[..., 0:1], axis=-1)[..., 0]
    out_v = xp.take_along_axis(candidates, info[..., 1:2], axis=-1)[..., 0]
    return xp.stack([out_u, out_v], axis=-1)


# ---------------------------------------------------------------------------
# Host scalar classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Coordinate:
    """A location on the unit cube sphere: cube face + warped uv.

    Host-side f64 twin of reference src/math/coordinate.rs:57-152.
    """

    side: int
    uv: np.ndarray  # f64 (2,)

    def __post_init__(self) -> None:
        self.uv = np.asarray(self.uv, dtype=np.float64)

    @staticmethod
    def from_world_position(world_position, model) -> "Coordinate":
        """Reference src/math/coordinate.rs:69-108."""
        local = model.position_world_to_local(np.asarray(world_position, np.float64))
        if model.is_spherical:
            side = int(pick_cube_face(local))
            raw_uv = face_raw_uv(local, side)
            uv = sigmoid_warp_forward(raw_uv)
            return Coordinate(side, uv)
        uv = np.clip(np.array([local[0] + 0.5, local[2] + 0.5]), 0.0, 1.0)
        return Coordinate(0, uv)

    def world_position(self, model, height: float) -> np.ndarray:
        """Reference src/math/coordinate.rs:110-130."""
        if model.is_spherical:
            local = local_position_from_side_uv(self.side, self.uv)
        else:
            local = np.array([self.uv[0] - 0.5, 0.0, self.uv[1] - 0.5])
        return model.position_local_to_world(local, float(height))

    def project_to_side(self, side: int, model) -> "Coordinate":
        """Reference src/math/coordinate.rs:134-151."""
        if not model.is_spherical:
            return self
        uv = project_uv_to_side(
            np.int32(self.side), np.int32(side), self.uv
        )
        return Coordinate(side, uv)


@dataclasses.dataclass(frozen=True, order=True)
class TileCoordinate:
    """Global tile id = (side, lod, x, y); reference src/math/coordinate.rs:156-279.

    lod 0 is the *coarsest* level (one tile per side); x/y are measured in
    tile sizes at that lod.
    """

    side: int
    lod: int
    x: int
    y: int

    INVALID: "TileCoordinate" = None  # set below

    @staticmethod
    def count(lod: int) -> int:
        """Tiles per axis at a lod (reference coordinate.rs:180-182)."""
        return 1 << lod

    @property
    def is_valid(self) -> bool:
        return self.lod >= 0

    def path(self, base: str, extension: str) -> str:
        """Disk path stem ``{side}_{lod}_{x}_{y}`` (reference coordinate.rs:184-186,282-286)."""
        return f"{base}/{self.side}_{self.lod}_{self.x}_{self.y}.{extension}"

    def parent(self) -> "TileCoordinate":
        """Reference coordinate.rs:188-195 (lod-1 with floor-halved xy)."""
        return TileCoordinate(self.side, self.lod - 1, self.x >> 1, self.y >> 1)

    def children(self) -> Iterator["TileCoordinate"]:
        """Reference coordinate.rs:197-206."""
        for index in range(4):
            yield TileCoordinate(
                self.side,
                self.lod + 1,
                (self.x << 1) + index % 2,
                (self.y << 1) + index // 2,
            )

    def neighbours(self, spherical: bool) -> Iterator["TileCoordinate"]:
        """The 8 edge/corner neighbours, with cube-sphere edge wrap.

        Order matches reference coordinate.rs:209-218:
        up, right, down, left, up-left, up-right, down-right, down-left
        (offsets (0,-1),(1,0),(0,1),(-1,0),(-1,-1),(1,-1),(1,1),(-1,1)).
        """
        offsets = [(0, -1), (1, 0), (0, 1), (-1, 0), (-1, -1), (1, -1), (1, 1), (-1, 1)]
        for ox, oy in offsets:
            yield self.neighbour_coordinate((self.x + ox, self.y + oy), spherical)

    def neighbour_coordinate(self, pos, spherical: bool) -> "TileCoordinate":
        """Reference coordinate.rs:227-279."""
        n = TileCoordinate.count(self.lod)
        px, py = pos
        if spherical:
            oob_x = px < 0 or px >= n
            oob_y = py < 0 or py >= n
            if oob_x and oob_y:
                return TileCoordinate.INVALID
            if px < 0:
                edge = 1
            elif py < 0:
                edge = 2
            elif px >= n:
                edge = 3
            elif py >= n:
                edge = 4
            else:
                edge = 0
            cx = min(max(px, 0), n - 1)
            cy = min(max(py, 0), n - 1)
            neighbour_side = int(NEIGHBOURING_SIDES[self.side][edge])
            info = PROJECT_SIDE_INFO[self.side, neighbour_side]
            vals = {F0: 0, F1: n - 1, PS: cx, PT: cy}
            return TileCoordinate(
                neighbour_side, self.lod, vals[int(info[0])], vals[int(info[1])]
            )
        if px < 0 or py < 0 or px >= n or py >= n:
            return TileCoordinate.INVALID
        return TileCoordinate(self.side, self.lod, px, py)

    def __str__(self) -> str:
        return f"{self.side}_{self.lod}_{self.x}_{self.y}"


# u32::MAX sentinel of the reference becomes -1 in our int32 tensors.
TileCoordinate.INVALID = TileCoordinate(INVALID_TILE, INVALID_LOD, -1, -1)
