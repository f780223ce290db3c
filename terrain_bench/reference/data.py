"""A configuration's dataset read straight from its files: every tile's
texels and their box-filtered mips, on a device, and the samplers the frame
reads them with.

The files are the layout bevy_terrain streams: ``{root}/{path}/data/
{attachment}/{side}_{lod}_{x}_{y}.bin``, raw little-endian texels of
``texture_size``^2 with a ``border_size`` texel border. Mips follow
bevy_terrain's rule (``src/terrain_data/mod.rs``): a 2x2 box with the
average truncated; a one-channel 16-bit attachment averages only its
non-zero texels (0 is nodata).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

FORMATS = {"R16": (1, np.dtype("<u2"), 65535.0), "Rgba8": (4, np.dtype("u1"), 255.0)}


def tile_index(side, lod, x, y, data_lods: int):
    """Row of tile (side, lod, x, y) in :class:`Dataset`'s arrays: sides,
    then lods, then rows of y, then x."""
    per_side = (4 ** data_lods - 1) // 3
    return side * per_side + (4 ** lod - 1) // 3 + y * 2 ** lod + x


class Attachment:
    """One attachment's texels: ``mips[m]`` (tiles, S_m, S_m, C) int32 on
    the device, rows of y."""

    def __init__(self, spec: dict, files: list, device):
        self.spec = spec
        self.channels, dtype, self.max_value = FORMATS[spec["format"]]
        T = spec["texture_size"]
        self.size, self.border = T, spec["border_size"]
        raw = np.stack([np.fromfile(f, dtype=dtype).reshape(T, T, self.channels)
                        for f in files])
        self.mip0_host = raw
        m0 = torch.from_numpy(raw.astype(np.int32)).to(device)
        self.mips = [m0]
        for _ in range(1, spec["mip_level_count"]):
            p = self.mips[-1]
            n, s = p.shape[0], p.shape[1] // 2
            q = p.reshape(n, s, 2, s, 2, -1).permute(0, 1, 3, 2, 4, 5).reshape(n, s, s, 4, -1)
            if self.channels == 1 and spec["format"] == "R16":
                count = (q != 0).sum(dim=3)
                child = torch.where(count > 0, q.sum(dim=3) // count.clamp(min=1), 0)
            else:
                child = q.sum(dim=3) // 4
            self.mips.append(child)
        # the border inset: a tile's [0, 1] maps to the texels inside the border
        self.inset_scale = (T - 2 * self.border) / T
        self.inset = self.border / T


class Dataset:
    def __init__(self, cfg: dict, root, device):
        self.cfg = cfg
        self.device = torch.device(device)
        D = cfg["data_lod_count"]
        self.data_lods = D
        sides = 1 if cfg["model"]["kind"] == "planar" else 6
        keys = [(s, lod, x, y) for s in range(sides) for lod in range(D)
                for y in range(1 << lod) for x in range(1 << lod)]
        assert [tile_index(*k, D) for k in keys] == list(range(len(keys)))
        base = Path(root) / cfg["name"] / "data"
        self.att = [Attachment(a, [base / a["name"] / f"{s}_{lod}_{x}_{y}.bin"
                                   for s, lod, x, y in keys], self.device)
                    for a in cfg["attachments"]]

    def height_at(self, side: int, lod: int, st) -> float:
        """The probe of bevy_terrain's ``sample_height``: a bilinear sample
        (texel centres at +0.5, clamped to the edge) of mip 0 of the data
        tile at ``lod`` holding face point ``st``, in [0, 1]."""
        a = self.att[0]
        n = 1 << lod
        xy = np.minimum(np.asarray(st, np.float64) * n, n - 1e-6)
        ix, iy = int(xy[0]), int(xy[1])
        uv = (xy - [ix, iy]) * a.inset_scale + a.inset
        tex = a.mip0_host[tile_index(side, lod, ix, iy, self.data_lods)]
        S = a.size
        p = uv * S - 0.5
        b = np.floor(p).astype(int)
        f = p - b

        def texel(x, y):
            return float(tex[np.clip(y, 0, S - 1), np.clip(x, 0, S - 1), 0])

        v00, v10 = texel(b[0], b[1]), texel(b[0] + 1, b[1])
        v01, v11 = texel(b[0], b[1] + 1), texel(b[0] + 1, b[1] + 1)
        top = v00 + (v10 - v00) * f[0]
        bot = v01 + (v11 - v01) * f[0]
        return (top + (bot - top) * f[1]) / a.max_value


def halfgrid(att: Attachment, rows, d, win, grid: int):
    """The tiles' values on the (2 grid + 1)^2 half-grid over their window
    of a data tile, (N, K, K, C) float64 raw texels, rows of y.

    A tile ``d`` lods below its data tile covers the window ``win`` (its
    corner in the data tile's [0, 1]^2) of side 2^-d. It reads mip
    m = clip(log2(T) - 5 - d, 1, min(mips - 1, log2(T) - 6)), whose texel
    density is about the half-grid's, inside one 64x64 texel window at
    32-texel blocks: the block (bx, by) = clip(trunc(start / 32), 0,
    S_m / 32 - 2) of the half-grid's first point ``start``; point k sits at
    ``start + k dp`` (texel centres at +0.5, the border inset applied), and
    is the bilinear sample there, clamped to that window."""
    T = att.size
    K = 2 * grid + 1
    lo_mip, hi_mip = 1, min(len(att.mips) - 1, int(math.log2(T)) - 6)
    m = torch.clamp(int(math.log2(T)) - 5 - d, lo_mip, hi_mip)
    out = torch.zeros((rows.shape[0], K, K, att.channels), dtype=torch.float64,
                      device=rows.device)
    k = torch.arange(K, dtype=torch.float64, device=rows.device)
    r = torch.arange(64, device=rows.device)
    for mip in range(lo_mip, hi_mip + 1):
        sel = torch.nonzero(m == mip).flatten()
        if sel.numel() == 0:
            continue
        S = T >> mip
        size = float(S)
        start = (win[sel] * att.inset_scale + att.inset) * size - 0.5  # (n, 2)
        dp = torch.exp2(-d[sel].to(torch.float64)) / (2 * grid) * att.inset_scale * size
        block = torch.clamp(torch.trunc(start / 32.0), 0, max(S // 32 - 2, 0)).long()  # (n, 2)
        for c0 in range(0, sel.numel(), 512):
            idx = sel[c0:c0 + 512]
            b = block[c0:c0 + 512]
            ys = (b[:, 1, None] * 32 + r)[:, :, None]
            xs = (b[:, 0, None] * 32 + r)[:, None, :]
            patch = att.mips[mip][rows[idx][:, None, None], ys, xs].to(torch.float64)

            def weights(axis):
                p = start[c0:c0 + 512, axis, None] + k * dp[c0:c0 + 512, None] \
                    - b[:, axis, None] * 32.0
                p = p.clamp(0.0, 63.0)
                return torch.clamp(1.0 - (p[..., None] - r.to(torch.float64)).abs(), min=0.0)

            wx, wy = weights(0), weights(1)
            out[idx] = torch.einsum("nky,nyxc,nlx->nklc", wy, patch, wx)
    return out


def smooth(h: torch.Tensor) -> torch.Tensor:
    """The 1-2-1 smoothing of a half-grid (N, K, K, C) along both axes, the
    edge rows repeated: about the next coarser mip, the blend's sample."""
    def axis(x, dim):
        n = x.shape[dim]
        lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
        hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
        return 0.25 * lo + 0.5 * x + 0.25 * hi
    return axis(axis(h, 1), 2)


def at_uv(h: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear of half-grids (N, K, K, C) at tile uvs (N, ..., 2) in
    [0, 1]: (N, ..., C)."""
    K = h.shape[1]
    p = uv * (K - 1)
    i0 = torch.clamp(torch.floor(p), 0, K - 2).long()
    f = p - i0
    n = torch.arange(h.shape[0], device=h.device).reshape((-1,) + (1,) * (uv.dim() - 2))
    x0, y0 = i0[..., 0], i0[..., 1]
    fx, fy = f[..., 0:1], f[..., 1:2]
    v00, v10 = h[n, y0, x0], h[n, y0, x0 + 1]
    v01, v11 = h[n, y0 + 1, x0], h[n, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy


def trilinear(att: Attachment, rows, uv, level) -> torch.Tensor:
    """Per-point sample (..., C) in [0, 1] of data tiles ``rows`` at tile
    uv (border inset applied here) and fractional mip ``level``: bilinear on
    the two mips around it, clamped to the edge, mixed linearly."""
    n = len(att.mips)
    level = torch.clamp(level, 0.0, n - 1.000001)
    lo = torch.floor(level).long()
    frac = (level - lo)[..., None]
    tuv = uv * att.inset_scale + att.inset
    out_lo = torch.zeros(uv.shape[:-1] + (att.channels,), dtype=torch.float64, device=uv.device)
    out_hi = torch.zeros_like(out_lo)
    for m in range(n):
        need_lo, need_hi = lo == m, (lo + 1).clamp(max=n - 1) == m
        sel = need_lo | need_hi
        if not bool(sel.any()):
            continue
        S = att.mips[m].shape[1]
        p = tuv[sel] * S - 0.5
        b = torch.floor(p)
        f = p - b
        b = b.long()
        r = rows[sel]

        def tex(x, y):
            return att.mips[m][r, y.clamp(0, S - 1), x.clamp(0, S - 1)].to(torch.float64)

        v00, v10 = tex(b[:, 0], b[:, 1]), tex(b[:, 0] + 1, b[:, 1])
        v01, v11 = tex(b[:, 0], b[:, 1] + 1), tex(b[:, 0] + 1, b[:, 1] + 1)
        fx, fy = f[:, 0:1], f[:, 1:2]
        v = ((v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy)
        v = v / att.max_value
        out_lo[need_lo] = v[need_lo[sel]]
        out_hi[need_hi] = v[need_hi[sel]]
    return out_lo + (out_hi - out_lo) * frac
