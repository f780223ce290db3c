"""One frame of the terrain in float64, from the dataset's files and the
camera alone: the approximate height under the view, the refined tile list,
the morphed vertex grids and their lit colours.

The rules are bevy_terrain's (``refine_tiles.wgsl``, ``functions.wgsl``,
``vertex.wgsl``, ``attachments.wgsl``, ``tile_tree.rs``), written as a plain
quadtree walk and per-vertex formulas over the data tiles; none of it is
the program's code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import geometry as geo
from reference.data import at_uv, halfgrid, smooth, tile_index

KEY_BIAS = 1 << 23


def keys(side, lod, x, y) -> np.ndarray:
    """One int64 key per tile (side, lod, x, y)."""
    side, lod, x, y = (np.asarray(v, np.int64) for v in (side, lod, x, y))
    return (((side << 6) | lod) << 48) | ((x + KEY_BIAS) << 24) | (y + KEY_BIAS)


def unkey(k: np.ndarray) -> tuple:
    k = np.asarray(k, np.int64)
    return ((k >> 54) & 63, (k >> 48) & 63, ((k >> 24) & 0xFFFFFF) - KEY_BIAS,
            (k & 0xFFFFFF) - KEY_BIAS)


def probe(vs: dict, data, eye: np.ndarray, previous: float) -> float:
    """bevy_terrain's approximate height (``tile_tree.rs``
    ``update_approximate_height``): the height under the view, sampled at
    the blend lod of the distance from the view to the ground at the
    previous frame's approximate height, blended toward the next coarser
    lod; data lods past the dataset's read its finest tile."""
    g = geo.ground(vs, eye, previous)
    dist = float(np.linalg.norm(eye - g))
    target = math.inf if dist == 0.0 else math.log2(vs["blend_distance"] / dist)
    target = min(target, vs["lod_count"] - 0.00001)
    lod = max(int(target), 0)
    side, st = geo.eye_coordinate(vs, eye)

    def sample(level):
        return data.height_at(side, min(level, data.data_lods - 1), st)

    value = sample(lod)
    if lod > 0:
        ratio = float(np.clip((lod + vs["blend_range"] - target) / vs["blend_range"], 0.0, 1.0))
        if ratio > 0.0:
            value = value + (sample(lod - 1) - value) * ratio
    return vs["min_h"] + (vs["max_h"] - vs["min_h"]) * value


def _t(x, dev):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)


def walk(vs: dict, eye: np.ndarray, height: float, vp: np.ndarray, dev) -> dict:
    """The refined tile list by a plain quadtree walk from the roots (one per
    face). A tile is kept when its bounding volume meets the frustum (with
    culling on), and divided while the view distance of its closest point to
    the view, at ``height`` above the surface, is under subdivision_distance
    / 2^lod (and lod + 1 < refinement_count); a kept tile that is not divided
    is emitted.

    Returns {"keys": emitted keys, "nodes": {key: (visible, divided,
    visible margin, divide margin)}} over every tile the walk looked at; a
    margin is how far the decision lay from its threshold, relative to it."""
    planes = _t(geo.frustum_planes(vp), dev)
    views = _t(geo.view_coordinates(vs, eye), dev)
    eye_t = _t(eye, dev)
    hmin, hmax = min(vs["min_h"], 0.0), max(vs["max_h"], 0.0)
    side = torch.arange(vs["sides"], device=dev)
    x = torch.zeros_like(side)
    y = torch.zeros_like(side)
    lod = 0
    nodes, emitted = {}, []
    while side.numel():
        n = float(1 << lod)
        if vs["culling"]:
            vis, m_vis = _visible(vs, side, lod, x, y, planes, hmin, hmax)
        else:
            vis = torch.ones_like(side, dtype=torch.bool)
            m_vis = torch.full(side.shape, math.inf, dtype=torch.float64, device=dev)
        st = torch.clamp(views[side] * n - torch.stack([x, y], -1).to(torch.float64), 0.0, 1.0)
        pos, up = geo.surface(vs, side, (x + st[:, 0]) / n, (y + st[:, 1]) / n)
        dist = torch.linalg.vector_norm(pos + height * up - eye_t, dim=-1)
        thr = vs["subdivision_distance"] / n
        div = (dist < thr) & (lod + 1 < vs["refinement_count"])
        m_div = (dist / thr - 1.0).abs()
        k = keys(side.cpu(), lod, x.cpu(), y.cpu())
        for key, a, b, c, d in zip(k.tolist(), vis.tolist(), div.tolist(), m_vis.tolist(),
                                   m_div.tolist()):
            nodes[key] = (a, b, c, d)
        emit = vis & ~div
        emitted.append(k[emit.cpu().numpy()])
        go = vis & div
        side, x, y = side[go], x[go], y[go]
        sub = torch.arange(4, device=dev).repeat(side.numel())
        side = side.repeat_interleave(4)
        x = (x.repeat_interleave(4) << 1) + (sub & 1)
        y = (y.repeat_interleave(4) << 1) + (sub >> 1)
        lod += 1
    return {"keys": np.concatenate(emitted), "nodes": nodes}


def _visible(vs, side, lod, x, y, planes, hmin, hmax):
    """The conservative frustum test of a tile's bounding volume (the
    culling of refine_tiles): a plane's test passes where the volume's
    support reaches the inside. A planar tile's volume is its box over the
    height range; a cube-sphere tile's a sphere at its centre's mid height,
    of radius (R + hmax) min(1.2 (pi / 2) 2^-lod, pi) + (hmax - hmin).
    Returns (visible, margin): the margin, the smallest |support| over the
    planes relative to the volume's reach along the plane."""
    n = float(1 << lod)
    hmid = 0.5 * (hmin + hmax)
    centre, up = geo.surface(vs, side, (x + 0.5) / n, (y + 0.5) / n)
    p = centre + hmid * up
    d = p @ planes[:, :3].T + planes[:, 3]  # (N, 5)
    if vs["spherical"]:
        theta = min(1.2 * (math.pi / 2.0) / n, math.pi)
        r = torch.full_like(d, (vs["radius_m"] + abs(hmax)) * theta + (hmax - hmin))
    else:
        half = 0.5 * vs["side_m"] / n
        nrm = planes[:, :3]
        r = ((nrm[:, 0].abs() + nrm[:, 2].abs()) * half
             + nrm[:, 1].abs() * 0.5 * (hmax - hmin)).expand_as(d)
    s = d + r
    return (s >= 0).all(dim=-1), (s.abs() / r).min(dim=-1).values


def split_margin(program_keys: np.ndarray, ref: dict) -> float:
    """How near its threshold the reference's deciding test lay, for the
    tile-list difference that is farthest from one (0 when the lists are
    equal; infinite for a key listed twice or a tile the reference never
    reached the parent of). For a tile only the program lists: the
    reference's test at the deepest of it and its ancestors that the walk
    looked at (it emitted, divided or culled there). For a tile only the
    reference lists: the program emitted an ancestor (that ancestor's
    divide test), something below it (its own divide test), or culled on
    the way (the smallest visible margin on the path)."""
    pk = np.asarray(program_keys, np.int64)
    if len(np.unique(pk)) != len(pk):
        return math.inf
    nodes, rk = ref["nodes"], set(ref["keys"].tolist())
    pset = set(pk.tolist())
    worst = 0.0

    def path(key):
        s, lod, x, y = (int(v) for v in unkey(key))
        return [int(keys(s, lod - j, x >> j, y >> j)) for j in range(lod, -1, -1)]

    def decision(node_key):
        vis, div, mv, md = nodes[node_key]
        return mv if not vis else md

    for key in pset - rk:
        seen = [k for k in path(key) if k in nodes]
        if not seen:
            return math.inf
        worst = max(worst, decision(seen[-1]))
    prefixes = {}
    for key in pset:
        for j, a in enumerate(path(key)[:-1]):
            prefixes[a] = True
    for key in rk - pset:
        p = path(key)
        ancestors = [a for a in p[:-1] if a in pset]
        if ancestors:
            m = nodes[ancestors[-1]][3]
        elif key in prefixes:
            m = nodes[key][3]
        else:
            m = min(nodes[a][2] for a in p)
        worst = max(worst, m)
    return worst


def mesh(vs: dict, data, tile_keys: np.ndarray, eye: np.ndarray, height: float, dev) -> dict:
    """The tiles' morphed vertex grids, (N, G + 1, G + 1, ...) rows of v,
    and their data.

    Per vertex at grid uv (i, j) / G: the view distance d of its surface
    point at ``height``; its morph toward the even grid (i & ~1, j & ~1) / G
    by :func:`geometry.morph_ratio`; the height at the morphed uv from the
    tile's data, and the position on the surface there raised by it.

    The data: the tile's data lod is min(blend lod of its centre's
    distance, the tile's lod, lod_count - 1), at most the dataset's finest
    (every tile resident); :func:`data.halfgrid` over its window of that
    data tile, bilinear at the morphed uv, mixed toward the smoothed
    half-grid by the vertex's own blend ratio."""
    G = vs["grid"]
    side, lod, x, y = (torch.as_tensor(v, device=dev) for v in unkey(tile_keys))
    N = side.shape[0]
    n = torch.exp2(lod.to(torch.float64))
    eye_t = _t(eye, dev)
    g = torch.arange(G + 1, device=dev, dtype=torch.float64) / G
    u = g[None, None, :].expand(N, G + 1, G + 1)
    v = g[None, :, None].expand(N, G + 1, G + 1)
    B = (slice(None), None, None)

    def at(uu, vv):
        return geo.surface(vs, side[B].expand_as(uu), (x[B] + uu) / n[B], (y[B] + vv) / n[B])

    p0, up0 = at(u, v)
    d = torch.linalg.vector_norm(p0 + height * up0 - eye_t, dim=-1)
    ratio = geo.morph_ratio(vs, lod[B], d)
    i = torch.arange(G + 1, device=dev)
    even = ((i // 2) * 2).to(torch.float64) / G
    mu = u + (even[None, None, :] - u) * ratio
    mv = v + (even[None, :, None] - v) * ratio
    uv = torch.stack([mu, mv], dim=-1)

    pc, upc = geo.surface(vs, side, (x + 0.5) / n, (y + 0.5) / n)
    blend_c, _ = geo.blend(vs, torch.linalg.vector_norm(pc + height * upc - eye_t, dim=-1))
    dl = torch.clamp(torch.minimum(blend_c, lod), 0, vs["lod_count"] - 1)
    dl = torch.clamp(dl, max=data.data_lods - 1)
    dd = lod - dl
    rows = tile_index(side, dl, x >> dd, y >> dd, data.data_lods)
    win = torch.stack([x - ((x >> dd) << dd), y - ((y >> dd) << dd)], -1).to(torch.float64) \
        / torch.exp2(dd.to(torch.float64))[:, None]

    hatt = data.att[0]
    half = halfgrid(hatt, rows, dd, win, G)
    fine = at_uv(half, uv)[..., 0]
    coarse = at_uv(smooth(half), uv)[..., 0]
    _, vratio = geo.blend(vs, d)
    hn = (fine + (coarse - fine) * vratio) / hatt.max_value
    h = vs["min_h"] + (vs["max_h"] - vs["min_h"]) * hn
    pm, upm = at(mu, mv)
    out = {"keys": np.asarray(tile_keys, np.int64), "positions": pm + h[..., None] * upm,
           "near_m": float(d.min()) if d.numel() else float("inf"),
           "normals": upm, "heights": h, "uvs": uv, "lod": lod, "side": side, "x": x, "y": y}
    if len(data.att) > 1:
        out["albedo_rows"], out["albedo_dd"], out["albedo_win"] = rows, dd, win
    return out


def shading_normals(vs: dict, m: dict) -> torch.Tensor:
    """The lit surface's normals at the vertices (attachments.wgsl's
    normal from height differences): central differences of the vertex
    heights over the grid (one-sided at the edges, over two spacings), the
    spacing side_length / 2^lod / G with side_length the plane's side or
    pi R / 4 on a sphere, in the face's tangent frame."""
    h = m["heights"]
    G = vs["grid"]

    def diff(dim):
        k = h.shape[dim]
        lo = torch.cat([h.narrow(dim, 0, 1), h.narrow(dim, 0, k - 1)], dim=dim)
        hi = torch.cat([h.narrow(dim, 1, k - 1), h.narrow(dim, k - 1, 1)], dim=dim)
        return hi - lo

    side_length = math.pi / 4.0 * vs["radius_m"] if vs["spherical"] else vs["side_m"]
    spacing = (side_length / torch.exp2(m["lod"].to(torch.float64)) / G)[:, None, None]
    du, dv = diff(2) / (2.0 * spacing), diff(1) / (2.0 * spacing)
    n = m["normals"]
    if vs["spherical"]:
        fu = torch.as_tensor(geo.FACE_UP, dtype=torch.float64, device=n.device)[m["side"]]
        t = torch.linalg.cross(fu[:, None, None, :].expand_as(n), n)
        t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        b = torch.linalg.cross(n, t)
    else:
        t = torch.zeros_like(n)
        t[..., 0] = 1.0
        b = torch.zeros_like(n)
        b[..., 2] = 1.0
    out = -du[..., None] * t - dv[..., None] * b + n
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def albedo(data, m: dict, index: int) -> torch.Tensor:
    """Attachment ``index`` at the vertices, (N, G + 1, G + 1, C) in [0, 1]:
    its half-grid over the height's data window, bilinear at the morphed
    uvs (one data lod, no blend)."""
    att = data.att[index]
    G = m["heights"].shape[1] - 1
    half = halfgrid(att, m["albedo_rows"], m["albedo_dd"], m["albedo_win"], G)
    return at_uv(half, m["uvs"]) / att.max_value


def pbr(material: dict, base: torch.Tensor, normal: torch.Tensor, pos: torch.Tensor,
        eye: np.ndarray) -> torch.Tensor:
    """Filament's direct lighting as bevy_pbr writes it, per directional
    light: GGX distribution, height-correlated Smith visibility, Schlick
    Fresnel (f90 = saturate(50 * 0.33 * sum f0)), Burley diffuse; plus the
    flat ambient on the diffuse colour. ``base`` RGBA in [0, 1]; alpha
    passes through."""
    rgb, alpha = base[..., :3], base[..., 3:]
    metal, refl = material["metallic"], material["reflectance"]
    diffuse_color = rgb * (1.0 - metal)
    f0 = 0.16 * refl * refl * (1.0 - metal) + rgb * metal
    pr = min(max(material["perceptual_roughness"], 0.089), 1.0)
    a = pr * pr
    a2 = a * a
    v = _t(eye, pos.device) - pos
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(min=1e-8)

    def dot(p, q):
        return (p * q).sum(-1, keepdim=True)

    def schlick(f0_, f90, c):
        return f0_ + (f90 - f0_) * (1.0 - c) ** 5

    nov = dot(normal, v).clamp(min=1e-4)
    out = torch.zeros_like(rgb)
    for light in material["lights"]:
        ld = -np.asarray(light["direction"], np.float64)
        l = _t(ld / np.linalg.norm(ld), pos.device)
        radiance = _t(np.asarray(light["color"], np.float64) * light["illuminance"], pos.device)
        hv = l + v
        hv = hv / torch.linalg.vector_norm(hv, dim=-1, keepdim=True).clamp(min=1e-8)
        nol = dot(normal, l).clamp(0.0, 1.0)
        noh = dot(normal, hv).clamp(0.0, 1.0)
        loh = dot(hv, l).clamp(0.0, 1.0)
        f = noh * noh * (a2 - 1.0) + 1.0
        d_ggx = a2 / (math.pi * f * f).clamp(min=1e-8)
        vis = 0.5 / (nol * torch.sqrt((nov - a2 * nov) * nov + a2)
                     + nov * torch.sqrt((nol - a2 * nol) * nol + a2)).clamp(min=1e-8)
        f90 = (f0 * (50.0 * 0.33)).sum(-1, keepdim=True).clamp(0.0, 1.0)
        spec = d_ggx * vis * schlick(f0, f90, loh)
        fd90 = 0.5 + 2.0 * a * loh * loh
        fd = schlick(1.0, fd90, nol) * schlick(1.0, fd90, nov) / math.pi
        out = out + (diffuse_color * fd + spec) * radiance * nol
    out = out + diffuse_color * _t(material.get("ambient", (0.05, 0.05, 0.05)), pos.device)
    return torch.cat([out, alpha], dim=-1)
