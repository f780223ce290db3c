"""How ``correct`` is decided for a frame: the program's products against the
plain reference's (``reference/``: float64, from the configuration, the
dataset's files and the camera; nothing of the program) at the same camera
and approximate height.

A frame's products: the refined tile list as keys, the tiles' morphed mesh
(positions, heights, uvs) and lit vertex colours in key order, the drawn
image. The numbers (:func:`compare`), each the worst over the frames; a
cell's traffic file names the ones it holds and their limits
(``check.limits``):

* ``split_margin``: the tile lists. 0 when they are equal; else, over the
  tiles one list holds and the other does not, the largest distance from
  its threshold (relative) of the reference's test that decided the tile
  (:func:`reference.frame.split_margin`), so that a test the two sides
  read on either side of its threshold within rounding reads small, and a
  list that is wrong reads large;
* ``pos_m``, ``height_m``, ``uv``: the largest gap of a vertex's position,
  height and morphed uv over the tiles both lists hold;
* ``rgb``: the largest gap of a lit vertex colour (RGBA) there;
* ``image_mean``: the mean gap of the drawn image over every pixel and
  channel, a pixel covered on one side only counting its colour against
  the background (so it holds the coverage too). The reference draws its
  own tile list with its own rasteriser.

The control (:func:`reference_frame` with ``control=True``) is the
reference put in the program's place with each layer's product held in
bfloat16, the precision below the float32 the configuration states, as the
next layer reads it: the camera (its position, the approximate height, the
view-projection) as the tile walk, the mesh and the image read it; the mesh
(positions, normals, heights, uvs) as the colours and the image read it;
the colours; the image.

The approximate height is the one input carried from frame to frame
(bevy_terrain's ``update_approximate_height`` starts from the previous
frame's): the reference replays it over the cameras the program was given,
in order, from the configuration's mid height (:func:`heights`).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import frame as ref
from reference import geometry as geo
from reference.data import Dataset
from reference.raster import draw

NUMBERS = ("split_margin", "pos_m", "height_m", "uv", "rgb", "image_mean")


def keys_of(tiles, live: int) -> torch.Tensor:
    """One int64 key per live tile from (side, lod, x, y), as
    :func:`reference.frame.keys` makes them."""
    xy = tiles.tile_xy[:live].long() + ref.KEY_BIAS
    return ((((tiles.tile_side[:live].long() << 6) | tiles.tile_lod[:live].long()) << 48)
            | (xy[:, 0] << 24) | xy[:, 1])


def products(out, image) -> dict:
    """One frame's products of the program on the host, live tiles in key
    order."""
    live = int(out.tiles.tile_count)
    keys = keys_of(out.tiles, live)
    order = torch.argsort(keys)
    mesh = out.mesh
    pick = (lambda x: x[:live][order].detach().double().cpu())
    return {
        "keys": keys[order].cpu().numpy(),
        "positions": pick(mesh.positions), "heights": pick(mesh.heights),
        "uvs": pick(mesh.uvs), "colors": pick(out.colors),
        "image": image.detach().double().cpu(),
    }


def heights(cfg: dict, data: Dataset, eyes: list) -> list:
    """The approximate height of each of a run's frames, given the eye of
    every frame the program was asked for, in order."""
    vs = geo.view_settings(cfg)
    h = 0.5 * (vs["min_h"] + vs["max_h"])
    out = []
    for eye in eyes:
        h = ref.probe(vs, data, np.asarray(eye, np.float64), h)
        out.append(h)
    return out


def _bf16(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(x.dtype)
    return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16).double().numpy()


def reference_frame(cfg: dict, traffic: dict, data: Dataset, eye, vp, height: float, device,
                    control: bool = False) -> dict:
    """The reference's products of one frame (or, with ``control``, the
    control's; module docstring)."""
    vs = geo.view_settings(cfg)
    eye, vp = np.asarray(eye, np.float64), np.asarray(vp, np.float64)
    if control:
        eye, vp, height = _bf16(eye), _bf16(vp), float(_bf16(np.float64(height)))
    walk = ref.walk(vs, eye, height, vp, device)
    tile_keys = np.sort(walk["keys"])
    m = ref.mesh(vs, data, tile_keys, eye, height, device)
    if control:
        for name in ("positions", "normals", "heights", "uvs"):
            m[name] = _bf16(m[name])
    mat = cfg["material"]
    normals = ref.shading_normals(vs, m)
    base = ref.albedo(data, m, mat["albedo_attachment"])
    colors = ref.pbr(mat, base, normals, m["positions"], eye)
    w, h = traffic["size"]
    image = draw(vs, data, m, normals, vp, eye, w, h, mat, mat["albedo_attachment"])
    if control:
        colors, image = _bf16(colors), _bf16(image)
    return {"walk": walk, "keys": tile_keys, "near_m": m["near_m"],
            "positions": m["positions"].cpu(),
            "heights": m["heights"].cpu(), "uvs": m["uvs"].cpu(), "colors": colors.cpu(),
            "image": image.cpu()}


def compare(got: dict, want: dict) -> dict:
    """The numbers of one frame (module docstring), and two readings held
    to no limit: ``tiles_diff``, the tiles in one list and not in the
    other, and ``near_m``, the reference's least view distance of a
    vertex."""
    gk, wk = np.asarray(got["keys"]), np.asarray(want["keys"])
    out = {"split_margin": ref.split_margin(gk, want["walk"]),
           "tiles_diff": float(len(np.setxor1d(gk, wk))), "near_m": want["near_m"]}
    _, gi, wi = np.intersect1d(gk, wk, assume_unique=False, return_indices=True)
    for name, key in (("pos_m", "positions"), ("height_m", "heights"), ("uv", "uvs"),
                      ("rgb", "colors")):
        x, y = got[key][gi], want[key][wi]
        out[name] = float((x - y).abs().max()) if x.numel() else 0.0
        if not bool(torch.isfinite(x).all()):
            out[name] = float("inf")
    gap = (got["image"] - want["image"]).abs()
    out["image_mean"] = float(gap.mean()) if bool(torch.isfinite(gap).all()) else float("inf")
    return out


def worst(per_frame: list) -> dict:
    """Each number's worst over the frames (``near_m``: its least);
    infinite with no frame."""
    out = {n: max((f[n] for f in per_frame), default=float("inf"))
           for n in NUMBERS + ("tiles_diff",)}
    out["near_m"] = min((f["near_m"] for f in per_frame), default=float("inf"))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell's traffic gives a limit holds it."""
    return all(numbers[n] <= limit for n, limit in limits.items())
