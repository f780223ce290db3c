"""A plain z-buffer rasteriser and the per-pixel shading of a frame.

Every tile's grid, with a skirt (a ring of its edge vertices lowered by 5%
of the tile's edge length, drawn with the edge's attributes), is cut into
two triangles a quad: (v[r, c], v[r, c + 1], v[r + 1, c]) and (v[r + 1, c],
v[r, c + 1], v[r + 1, c + 1]). A triangle with a vertex at clip w <= 1e-4
is dropped (no clipping). Each triangle is tested at the pixel centres
(+0.5) of its bounding box; the nearest (largest 1/w, linear on the screen)
covering triangle wins a pixel. At a pixel the attributes are interpolated
perspective-correct; the base colour is the albedo sampled per pixel from
the data tile of the pixel's blend lod at the mip of the uv's screen
footprint (trilinear), then lit by :func:`frame.pbr`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import geometry as geo
from reference.data import tile_index, trilinear
from reference.frame import pbr

NEAR_W = 1e-4


def _skirted(m: dict, spherical: bool):
    """(N, G + 3, G + 3, 3) positions with the skirt ring, and the flat
    index of the grid vertex whose attributes each vertex takes."""
    pos = m["positions"]
    N, G1 = pos.shape[0], pos.shape[1]
    S = G1 + 2
    rr = torch.arange(S, device=pos.device).sub(1).clamp(0, G1 - 1)
    padded = pos[:, rr][:, :, rr]
    if spherical:
        down = -padded / torch.linalg.vector_norm(padded, dim=-1, keepdim=True)
    else:
        down = torch.zeros_like(padded)
        down[..., 1] = -1.0
    edge = torch.linalg.vector_norm(pos[:, 0, -1] - pos[:, 0, 0], dim=-1)
    ring = torch.arange(S, device=pos.device)
    ring = (ring == 0) | (ring == S - 1)
    rim = (ring[:, None] | ring[None, :]).to(pos.dtype)[None, :, :, None]
    skirted = padded + down * (0.05 * edge)[:, None, None, None] * rim
    base = torch.arange(N, device=pos.device)[:, None, None] * (G1 * G1)
    vmap = (base + rr[None, :, None] * G1 + rr[None, None, :]).reshape(-1)
    return skirted, vmap


def _triangles(N: int, S: int, dev) -> torch.Tensor:
    r = torch.arange(S - 1, device=dev)[:, None]
    c = torch.arange(S - 1, device=dev)[None, :]
    v00, v01 = r * S + c, r * S + c + 1
    v10, v11 = (r + 1) * S + c, (r + 1) * S + c + 1
    t = torch.stack([torch.stack([v00, v01, v10], -1), torch.stack([v10, v01, v11], -1)], 2)
    t = t.reshape(-1, 3)
    return (torch.arange(N, device=dev)[:, None, None] * (S * S) + t[None]).reshape(-1, 3)


def project(p: torch.Tensor, vp: np.ndarray, width: int, height: int):
    """World -> (screen x, screen y, clip w); the screen's origin top left,
    y down."""
    m = torch.as_tensor(vp, dtype=torch.float64, device=p.device)
    clip = p @ m[:, :3].T + m[:, 3]
    w = clip[:, 3]
    sx = (clip[:, 0] / w * 0.5 + 0.5) * width
    sy = (0.5 - clip[:, 1] / w * 0.5) * height
    return sx, sy, w


def cover(sx, sy, w, tris, width: int, height: int):
    """The winning triangle of every pixel, (H * W,) int64, -1 where none."""
    dev = sx.device
    tx, ty, tw = sx[tris], sy[tris], w[tris]
    keep = (tw > NEAR_W).all(dim=1)
    x0 = torch.ceil(tx.min(1).values - 0.5).clamp(min=0)
    x1 = torch.floor(tx.max(1).values - 0.5).clamp(max=width - 1)
    y0 = torch.ceil(ty.min(1).values - 0.5).clamp(min=0)
    y1 = torch.floor(ty.max(1).values - 0.5).clamp(max=height - 1)
    keep &= (x1 >= x0) & (y1 >= y0)
    ids = torch.nonzero(keep).flatten()
    span = torch.maximum(x1 - x0, y1 - y0)[ids] + 1
    B = torch.exp2(torch.ceil(torch.log2(span))).long()
    zbuf = torch.full((width * height,), -math.inf, dtype=torch.float64, device=dev)
    cands = []
    for b in torch.unique(B).tolist():
        sel = ids[B == b]
        off = torch.arange(b * b, device=dev)
        dx, dy = (off % b).to(torch.float64), (off // b).to(torch.float64)
        step = max(1, (1 << 22) // (b * b))
        for c0 in range(0, sel.numel(), step):
            t = sel[c0:c0 + step]
            px = x0[t, None] + dx
            py = y0[t, None] + dy
            ok = (px <= x1[t, None]) & (py <= y1[t, None])
            X, Y, W = tx[t], ty[t], tw[t]
            cx, cy = px + 0.5, py + 0.5
            e = []
            for i in range(3):
                j, k = (i + 1) % 3, (i + 2) % 3
                e.append((X[:, k, None] - X[:, j, None]) * (cy - Y[:, j, None])
                         - (Y[:, k, None] - Y[:, j, None]) * (cx - X[:, j, None]))
            area = e[0] + e[1] + e[2]
            inside = ok & (area != 0)
            for i in range(3):
                inside &= e[i] * torch.sign(area) >= 0
            inv_w = sum(e[i] / area / W[:, i, None] for i in range(3))
            tri = t[:, None].expand_as(px)
            pix = (py * width + px).long()
            cands.append((pix[inside], inv_w[inside], tri[inside]))
    pix = torch.cat([c[0] for c in cands]) if cands else torch.zeros(0, dtype=torch.long,
                                                                      device=dev)
    inv_w = torch.cat([c[1] for c in cands]) if cands else torch.zeros(0, dtype=torch.float64,
                                                                         device=dev)
    tri = torch.cat([c[2] for c in cands]) if cands else torch.zeros(0, dtype=torch.long,
                                                                      device=dev)
    zbuf.scatter_reduce_(0, pix, inv_w, reduce="amax")
    win = torch.full((width * height,), -1, dtype=torch.long, device=dev)
    front = inv_w == zbuf[pix]
    win.scatter_reduce_(0, pix[front], tri[front], reduce="amax")
    return win


def draw(vs: dict, data, m: dict, normals: torch.Tensor, vp: np.ndarray, eye: np.ndarray,
         width: int, height: int, material: dict, albedo_index: int) -> torch.Tensor:
    """The frame's (H, W, 4) image, 0 where no tile covers a pixel."""
    dev = m["positions"].device
    pos_s, vmap = _skirted(m, vs["spherical"])
    N, S = pos_s.shape[0], pos_s.shape[1]
    tris = _triangles(N, S, dev)
    sx, sy, w = project(pos_s.reshape(-1, 3), vp, width, height)
    win = cover(sx, sy, w, tris, width, height)
    img = torch.zeros((height * width, 4), dtype=torch.float64, device=dev)
    pix = torch.nonzero(win >= 0).flatten()
    if pix.numel() == 0:
        return img.reshape(height, width, 4)
    t = tris[win[pix]]
    X, Y, W = sx[t], sy[t], w[t]
    cx = (pix % width).to(torch.float64) + 0.5
    cy = (pix // width).to(torch.float64) + 0.5
    e, ax, ay = [], [], []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        e.append((X[:, k] - X[:, j]) * (cy - Y[:, j]) - (Y[:, k] - Y[:, j]) * (cx - X[:, j]))
        ax.append(-(Y[:, k] - Y[:, j]))
        ay.append(X[:, k] - X[:, j])
    area = (e[0] + e[1] + e[2])[:, None]
    L = torch.stack(e, -1) / area
    Lx, Ly = torch.stack(ax, -1) / area, torch.stack(ay, -1) / area
    q = L / W
    D = q.sum(-1, keepdim=True)
    bary = q / D
    vid = vmap[t]

    def interp(values):
        flat = values.reshape(-1, values.shape[-1])[vid]  # (P, 3, C)
        return (flat * bary[..., None]).sum(1)

    p = interp(m["positions"])
    n = interp(normals)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    uv3 = m["uvs"].reshape(-1, 2)[vid]
    uv = (uv3 * q[..., None]).sum(1) / D
    qx, qy = Lx / W, Ly / W
    Dx, Dy = qx.sum(-1, keepdim=True), qy.sum(-1, keepdim=True)
    duv_dx = ((uv3 * qx[..., None]).sum(1) - uv * Dx) / D
    duv_dy = ((uv3 * qy[..., None]).sum(1) - uv * Dy) / D

    G1 = m["positions"].shape[1]
    f = vid[:, 0] // (G1 * G1)
    lod, side, x, y = m["lod"][f], m["side"][f], m["x"][f], m["y"][f]
    blod, _ = geo.blend(vs, torch.linalg.vector_norm(p - torch.as_tensor(eye, device=dev),
                                                     dim=-1))
    a = torch.clamp(blod, max=data.data_lods - 1)
    scale = torch.exp2((a - lod).to(torch.float64))[:, None]
    st = (torch.stack([x, y], -1).to(torch.float64) + uv) * scale
    cell = torch.minimum(torch.floor(st), torch.exp2(a.to(torch.float64))[:, None] - 1).clamp(min=0)
    uv_a = st - cell
    cell = cell.long()
    rows = tile_index(side, a, cell[:, 0], cell[:, 1], data.data_lods)
    att = data.att[albedo_index]
    k = scale * att.inset_scale * att.size
    tdx, tdy = duv_dx * k, duv_dy * k
    rho2 = torch.maximum((tdx * tdx).sum(-1), (tdy * tdy).sum(-1))
    level = 0.5 * torch.log2(rho2.clamp(min=1e-12))
    base = trilinear(att, rows, uv_a, level)
    if base.shape[-1] < 4:
        base = torch.cat([base, torch.ones_like(base[:, :1]).expand(-1, 4 - base.shape[-1])], -1)
    img[pix] = pbr(material, base, n, p, eye)
    return img.reshape(height, width, 4)
