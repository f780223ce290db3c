"""Device-side preprocess compute over whole-lod tile stacks, in torch.

Torch twin of the JAX package's ``ops/preprocess_device.py``. The reference
runs split/stitch/downsample as GPU compute over 8x8 workgroups per tile
(src/preprocess/mod.rs:143-218, src/shaders/preprocess/{split,stitch,
downsample}.wgsl). Here a lod level's tiles are ONE (N, ts, ts, C) f32
stack on the caller's device and each pass is a few torch ops over the
stack:

* **split**: the 2-tap separable bilinear of the source rows, then columns
  (:func:`split_bilinear`), each tap a gather, a multiply and an add in
  separate correctly rounded ops: the same bits as the host numpy split
  (ops/preprocess.py). No dense product: cuBLAS would contract into FMAs
  (or TF32), and the rint after the scale to 65535 turns that ulp into a
  one-unit texel flip.
* **downsample**: gather each parent's 4 children by index (tile-granular
  ``index_select``), assemble the (2*center)^2 field, nodata-masked 2x2
  mean (downsample.wgsl:12-45).
* **stitch**: every border region is a gather of the neighbour's
  center-edge band + a STATIC transform (slice / flip / transpose) chosen
  by the cross-face remap code. The per-texel ``project_texels`` of
  stitch.wgsl:12-51 collapses to a signed axis permutation, so all 8
  regions x <=6 remap cases are static slicing. Missing neighbours
  clamp-repeat the tile's own edge (stitch.wgsl:98-103).
* **mips**: 2x2 box filter per level; the R16 nodata rule (skip zero
  texels, count-weighted) matches terrain_data/mod.rs:184-218.

The host numpy twins in ops/preprocess.py are the parity oracles. No op
here reads a tensor back to the host: the callers sync once per lod stack,
when they read it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
from bevy_terrain_tpu_torch.ops.preprocess import _project_texels


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without a stream sync: a CUDA copy goes
    from pinned memory, non-blocking (the caching host allocator keeps the
    pinned buffer until the copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


# ---------------------------------------------------------------------------
# split
# ---------------------------------------------------------------------------


def split_bilinear(source, x_taps, y_taps):
    """Bilinear resample of ``source`` (H, W, C) f32 at K row and L column
    positions -> (K, L, C) f32: the y pass, then the x pass.

    ``x_taps`` / ``y_taps``: (w0, w1, i0, i1) tensors on the source's device
    (ops/preprocess._tap_weights). Each multiply and add is its own op, so
    every value is rounded as the host numpy split rounds it."""
    xw0, xw1, x0, x1 = x_taps
    yw0, yw1, y0, y1 = y_taps
    band = source.index_select(0, y0) * yw0[:, None, None]
    band = band + source.index_select(0, y1) * yw1[:, None, None]  # (K, W, C)
    out = band.index_select(1, x0) * xw0[None, :, None]
    return out + band.index_select(1, x1) * xw1[None, :, None]


# ---------------------------------------------------------------------------
# downsample
# ---------------------------------------------------------------------------


def downsample_stack(children, child_idx, texture_size: int, border_size: int):
    """Parent tiles from child stacks (downsample.wgsl:12-45), batched.

    Args:
      children: (Nc, ts, ts, C) f32 child tiles (0 = nodata).
      child_idx: (Np, 4) integer indices (a tensor, or host numpy) into
        ``children`` in the reference child order (2x,2y),(2x+1,2y),
        (2x,2y+1),(2x+1,2y+1); -1 = missing (counts as nodata).

    Returns (Np, ts, ts, C) f32 parents (borders zero).
    """
    b, ts = border_size, texture_size
    cs = ts - 2 * b
    if isinstance(child_idx, np.ndarray):
        child_idx = to_device(child_idx, children.device)
    child_idx = child_idx.long()
    Np = child_idx.shape[0]
    C = children.shape[-1]

    present = (child_idx >= 0)[..., None, None, None]  # (Np, 4, 1, 1, 1)
    centers = children[:, b:b + cs, b:b + cs, :].index_select(
        0, child_idx.clamp(min=0).reshape(-1)
    ).reshape(Np, 4, cs, cs, C)
    centers = torch.where(present, centers, 0.0)

    # assemble (Np, 2cs, 2cs, C): quadrant q = (qx, qy) at block offsets
    top = torch.cat([centers[:, 0], centers[:, 1]], dim=2)
    bottom = torch.cat([centers[:, 2], centers[:, 3]], dim=2)
    field = torch.cat([top, bottom], dim=1)  # (Np, 2cs, 2cs, C)

    quads = field.reshape(Np, cs, 2, cs, 2, C).permute(0, 1, 3, 2, 4, 5)
    quads = quads.reshape(Np, cs, cs, 4, C)
    valid = (quads != 0).any(dim=-1)  # (Np, cs, cs, 4)
    count = valid.sum(dim=-1)
    total = (quads * valid[..., None]).sum(dim=3)
    avg = torch.where(
        (count > 0)[..., None], total / count.clamp(min=1)[..., None], 0.0
    )
    return F.pad(avg, (0, 0, b, b, b, b))


# ---------------------------------------------------------------------------
# stitch
# ---------------------------------------------------------------------------

# border region rects (x, y, w, h) and neighbour offsets per slot
# (stitch.wgsl:58-67, 79-88) — slot order up, right, down, left, up-left,
# up-right, down-right, down-left (coordinate.rs:209-218)


def _region_rects(size: int, b: int):
    cs = size - 2 * b
    off = b + cs
    bounds = [
        (b, 0, cs, b), (off, b, b, cs), (b, off, cs, b), (0, b, b, cs),
        (0, 0, b, b), (off, 0, b, b), (off, off, b, b), (0, off, b, b),
    ]
    offsets = [
        (0, cs), (-cs, 0), (0, -cs), (cs, 0),
        (cs, cs), (-cs, cs), (-cs, -cs), (cs, -cs),
    ]
    return bounds, offsets


class _RemapDescriptor(NamedTuple):
    """Static recipe: out[region] = maybe_flip(maybe_T(neigh[src_rect]))."""

    src_x: int
    src_y: int
    src_w: int
    src_h: int
    transpose: bool
    flip_x: bool
    flip_y: bool


@functools.lru_cache(maxsize=None)
def _remap_descriptor(orig_side: int, proj_side: int, slot: int,
                      size: int, border: int) -> _RemapDescriptor:
    """Derive the static transform equivalent of the per-texel remap
    (stitch.wgsl:12-51) for one (tile side, neighbour side, slot)."""
    bounds, offsets = _region_rects(size, border)
    x, y, w, h = bounds[slot]
    ox, oy = offsets[slot]
    xs, ys = np.meshgrid(np.arange(x, x + w), np.arange(y, y + h), indexing="xy")
    coords = np.stack([xs.ravel(), ys.ravel()], axis=-1) + np.array([ox, oy])
    remapped = _project_texels(coords, orig_side, proj_side, size)
    rx = remapped[:, 0].reshape(h, w)
    ry = remapped[:, 1].reshape(h, w)
    sx0, sy0 = int(rx.min()), int(ry.min())
    src_w, src_h = int(rx.max()) - sx0 + 1, int(ry.max()) - sy0 + 1
    # the remap is a signed axis permutation — find the matching one of the
    # 8 slice/transpose/flip transforms against the per-texel oracle
    probe = np.arange(size * size).reshape(size, size)
    want = probe[ry, rx]
    for transpose in (False, True):
        for flip_x in (False, True):
            for flip_y in (False, True):
                d = _RemapDescriptor(
                    sx0, sy0, src_w, src_h, transpose, flip_x, flip_y)
                got = _apply_descriptor_np(probe, d)
                if got.shape == want.shape and (got == want).all():
                    return d
    raise AssertionError(
        f"no static transform matches remap {(orig_side, proj_side, slot)}")


def _apply_descriptor_np(tile2d: np.ndarray, d: _RemapDescriptor) -> np.ndarray:
    s = tile2d[d.src_y:d.src_y + d.src_h, d.src_x:d.src_x + d.src_w]
    if d.transpose:
        s = s.T
    if d.flip_x:
        s = s[:, ::-1]
    if d.flip_y:
        s = s[::-1, :]
    return s


def _apply_descriptor(stack, d: _RemapDescriptor):
    """(N, ts, ts, C) -> (N, h, w, C) static slice/transpose/flip."""
    s = stack[:, d.src_y:d.src_y + d.src_h, d.src_x:d.src_x + d.src_w, :]
    if d.transpose:
        s = s.transpose(1, 2)
    if d.flip_x:
        s = s.flip(2)
    if d.flip_y:
        s = s.flip(1)
    return s


def stitch_plan(coordinates: list[TileCoordinate], index_of: dict,
                spherical: bool):
    """Host: neighbour indices + sides per tile for stitch_stack.

    ``index_of``: TileCoordinate -> row in the lod stack (tiles being
    stitched AND any extra neighbour rows appended by the caller).
    Returns (nbr_idx (N, 8) i32 with -1 missing, nbr_side (N, 8) i32).
    """
    N = len(coordinates)
    nbr_idx = np.full((N, 8), -1, np.int32)
    nbr_side = np.zeros((N, 8), np.int32)
    for i, c in enumerate(coordinates):
        for slot, n in enumerate(c.neighbours(spherical)):
            if n.is_valid and n in index_of:
                nbr_idx[i, slot] = index_of[n]
                nbr_side[i, slot] = n.side
    return nbr_idx, nbr_side


def stitch_stack(stack, tile_sides, nbr_idx, nbr_side, border_size: int,
                 spherical: bool):
    """Batched border stitch (stitch.wgsl:53-118) over a lod stack.

    Args:
      stack: (N, ts, ts, C) f32 — the tiles to stitch + any neighbour rows
        (only the first ``nbr_idx.shape[0]`` rows are stitched/returned).
        Not modified.
      tile_sides: (N,) host numpy int — cube side per stitched tile (static
        grouping; a lod stack holds few distinct sides).
      nbr_idx / nbr_side: from :func:`stitch_plan` (host numpy).

    Returns (Nst, ts, ts, C) f32 with all 8 border regions filled. Each
    region reads its neighbours from ``stack`` and its clamp fallback from
    the output being filled, as the JAX function does.
    """
    device = stack.device
    ts = stack.shape[1]
    b = border_size
    nbr_idx = np.asarray(nbr_idx)
    nbr_side = np.asarray(nbr_side)
    Nst = nbr_idx.shape[0]
    bounds, _ = _region_rects(ts, b)
    tile_sides = np.asarray(tile_sides)
    idx_all = to_device(nbr_idx.astype(np.int64), device)
    out = stack[:Nst].clone()
    cs = ts - 2 * b

    for slot in range(8):
        x, y, w, h = bounds[slot]
        idx = idx_all[:, slot]
        present = (idx >= 0)[:, None, None, None]
        gather = idx.clamp(min=0)

        # cases: (orig_side, proj_side) pairs present in this frame — a
        # static, tiny set (planar: 1; cube faces: <= 3 per slot)
        if spherical:
            pairs = sorted(
                {(int(o), int(p))
                 for o, p in zip(tile_sides[:Nst], nbr_side[:Nst, slot])}
            )
        else:
            pairs = [(0, 0)]
        region = None
        for (o, p) in pairs:
            d = _remap_descriptor(o, p, slot, ts, b)
            cand = _apply_descriptor(stack, d).index_select(0, gather)  # (Nst, h, w, C)
            if region is None:
                region = cand
            else:
                sel = (tile_sides[:Nst] == o) & (nbr_side[:Nst, slot] == p)
                region = torch.where(
                    to_device(sel, device)[:, None, None, None], cand, region)

        # missing neighbour: clamp-repeat own center edge (stitch.wgsl:98-103)
        ry = np.clip(np.arange(y, y + h), b, b + cs - 1)
        rx = np.clip(np.arange(x, x + w), b, b + cs - 1)
        own = out[:, to_device(ry[:, None], device), to_device(rx[None, :], device)]
        out[:, y:y + h, x:x + w] = torch.where(present, region, own).to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# border-delta readback
# ---------------------------------------------------------------------------
# Stitch only writes the border regions (stitch.wgsl:58-67) — border 2 of a
# 512 tile is ~1.5% of the texels. When the host already knows the
# interiors (it ran the bit-identical split/downsample itself), the D2H
# readback only needs these strips: extract_borders packs them into one
# compact (N, K) tensor on device, composite_borders splices them back
# into the host tiles.


def border_strip_length(texture_size: int, border_size: int,
                        channels: int) -> int:
    ts, b = texture_size, border_size
    return (2 * b * ts + 2 * (ts - 2 * b) * b) * channels


def extract_borders(stack, border_size: int):
    """(N, ts, ts, C) -> (N, K) compact border texels: top rows, bottom
    rows, left cols, right cols (corners ride the top/bottom strips)."""
    N, ts, _, C = stack.shape
    b = border_size
    top = stack[:, :b, :, :].reshape(N, -1)
    bottom = stack[:, ts - b:, :, :].reshape(N, -1)
    left = stack[:, b:ts - b, :b, :].reshape(N, -1)
    right = stack[:, b:ts - b, ts - b:, :].reshape(N, -1)
    return torch.cat([top, bottom, left, right], dim=1)


def composite_borders(tile: np.ndarray, strip: np.ndarray,
                      border_size: int) -> None:
    """Host: splice one tile's extract_borders strip back in place."""
    ts, _, C = tile.shape
    b = border_size
    k1 = b * ts * C
    k2 = (ts - 2 * b) * b * C
    tile[:b] = strip[0:k1].reshape(b, ts, C)
    tile[ts - b:] = strip[k1:2 * k1].reshape(b, ts, C)
    tile[b:ts - b, :b] = strip[2 * k1:2 * k1 + k2].reshape(ts - 2 * b, b, C)
    tile[b:ts - b, ts - b:] = strip[2 * k1 + k2:].reshape(ts - 2 * b, b, C)


def to_stored(x, dtype) -> torch.Tensor:
    """Integer-valued f32 ``x`` -> the stored width of ``dtype`` (uint8 or
    uint16), on its device, ready to read back. uint16 goes through int32
    to int16 holding the same bits (torch has few uint16 ops): read it back
    with ``.numpy().view(np.uint16)``, as :func:`read_stored` does."""
    dtype = np.dtype(dtype)
    if dtype == np.uint8:
        return x.to(torch.uint8)
    if dtype == np.uint16:
        i = x.to(torch.int32)
        return torch.where(i >= 32768, i - 65536, i).to(torch.int16)
    raise ValueError(f"no stored width for {dtype}")


def read_stored(x: torch.Tensor, dtype) -> np.ndarray:
    """Read a :func:`to_stored` tensor back as a host array of ``dtype``."""
    return x.cpu().numpy().view(np.dtype(dtype))


def stored_dtype(dtype) -> torch.dtype:
    """The torch dtype :func:`to_stored` gives for ``dtype``."""
    return {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16}[np.dtype(dtype)]


def from_stored(x: torch.Tensor) -> torch.Tensor:
    """A :func:`to_stored` tensor as integer-valued f32 again (int16 bits
    read as uint16)."""
    y = x.to(torch.float32)
    return torch.where(y < 0, y + 65536.0, y) if x.dtype == torch.int16 else y


# ---------------------------------------------------------------------------
# mips
# ---------------------------------------------------------------------------


def mip_stack(stack, mip_level_count: int, nodata_aware: bool,
              quantize: bool = True):
    """Box-filtered mip chain over a tile stack (terrain_data/mod.rs:143-219).

    ``stack``: (N, ts, ts, C) f32. Returns a list of per-level stacks
    [mip0, mip1, ...]; with ``nodata_aware`` (the R16 rule) zero texels are
    skipped and the average is count-weighted. ``quantize`` applies the
    host chain's truncating integer division per level
    (attachment.generate_mipmaps / reference mod.rs:144-198) — byte-exact
    with the integer-stored chain (f32 holds these integers exactly; the
    division quotients are quarters/thirds, so floor never straddles).
    """
    mips = [stack]
    for _ in range(1, mip_level_count):
        p = mips[-1]
        N, H, W, C = p.shape
        quads = p.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        quads = quads.reshape(N, H // 2, W // 2, 4, C)
        if nodata_aware:
            valid = quads != 0  # per channel (mod.rs:184-188)
            count = valid.sum(dim=3)
            total = (quads * valid).sum(dim=3)
            child = torch.where(
                count > 0, total / count.clamp(min=1), 0.0
            )
        else:
            child = quads.sum(dim=3) / 4.0
        mips.append(torch.floor(child) if quantize else child)
    return mips
