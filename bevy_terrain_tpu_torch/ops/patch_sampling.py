"""Gather-based patch plan: per-tile atlas lookup, patch geometry and the
quad-sorted fetch schedule — torch twin of the JAX package's ``ops/patch_sampling.py``.

Each tile of a frame samples ONE 16 KB quad of 2x2 texel blocks of its
atlas tile's mip chain (the quad covers the tile's uv window at the mip
whose texel density matches the vertex half-grid). The host block
builders (:func:`quad_rows`, :func:`blocks_from_tile`) are copied from the
JAX package unchanged; :func:`plan_patch_batch` computes the same
:class:`PatchBatch` on the device with torch ops, field for field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from bevy_terrain_tpu_torch.ops import coords, kernels
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig
from bevy_terrain_tpu_torch.ops.refinement import RefinementOutput

BLOCK = 32

# Block arrays are stored as *row-interleaved overlapping quads*: entry i
# holds the 2x2 block window (i, i+1, i+g, i+g+1) of its mip laid out as
# Q[r, 32q + c] = block_q[r, c] — a dense (32, 128) i32-native tile (zero
# lane padding), so ONE 16 KB DMA fetches a tile's whole patch AND the
# patch halves are plain lane slices (top = Q[:, :64] is [tl | tr], bottom
# = Q[:, 64:] is [bl | br]) — no in-kernel unpack shuffles at all. The
# patch fetch at frame scale is HBM random-access *latency* bound (16 KB
# vs 4 KB DMAs measured within 10%), so DMA count per tile is the whole
# cost: 4 singles = 2.16 ms, 2 pairs = 1.56 ms, 1 quad is the floor. Quad
# validity relies on patch_geometry clamping bx/by to g-2, which makes
# tr = tl+1 and bl = tl+g unconditionally. The 4x storage equals the
# lane-padded naive layout's footprint — no capacity regression.
QUAD_SHAPE = (BLOCK, 4 * BLOCK)


def quad_rows(blocks: np.ndarray, g: int) -> np.ndarray:
    """(g*g, 32, 32) texel-block mip run -> (g*g, 32, 128) quad rows.

    Entry i = blocks (i, i+1, i+g, i+g+1) concatenated along columns,
    clamped to the run; only entries with bx <= g-2 and by <= g-2 are ever
    requested (tl ids from patch_geometry), so clamped content is never
    read.
    """
    n = blocks.shape[0]
    idx = np.arange(n)
    return np.concatenate(
        [
            blocks,
            blocks[np.minimum(idx + 1, n - 1)],
            blocks[np.minimum(idx + g, n - 1)],
            blocks[np.minimum(idx + g + 1, n - 1)],
        ],
        axis=2,
    )


class PatchPlan(NamedTuple):
    """Static description of an attachment's unified block array."""

    texture_size: int
    mip_count: int
    min_mip: int  # fast path never uses mip 0 (block assembly limit)
    max_mip: int  # deepest mip with size >= 64 (2x2 blocks exist)
    bases: tuple  # per-mip flat block base offset (0 for mips < min_mip)
    total_blocks_per_slot: int
    border_size: int

    @property
    def usable(self) -> bool:
        return self.max_mip >= self.min_mip


def make_patch_plan(texture_size: int, mip_count: int, border_size: int) -> PatchPlan:
    """Layout of the unified blocked mip array for one attachment.

    Mips ``min_mip..max_mip`` (sizes texture/2 .. 64) are stored as
    consecutive runs of (32, 32) blocks: slot a's mip m occupies flat block
    indices ``base[m] + a * g_m^2 + by * g_m + bx`` where
    ``g_m = size_m / 32``.
    """
    min_mip = 1
    max_mip = min(mip_count - 1, int(math.log2(max(texture_size, 1))) - 6)
    bases = []
    per_slot = []
    offset = 0
    for m in range(mip_count):
        if min_mip <= m <= max_mip:
            g = (texture_size >> m) // BLOCK
            bases.append(offset)
            per_slot.append(g * g)
            offset += g * g
        else:
            bases.append(-1)
            per_slot.append(0)
    return PatchPlan(
        texture_size=texture_size,
        mip_count=mip_count,
        min_mip=min_mip,
        max_mip=max_mip,
        bases=tuple(bases),
        total_blocks_per_slot=sum(per_slot),
        border_size=border_size,
    )


def blocks_from_tile(mips: list[np.ndarray], plan: PatchPlan, channel: int = 0) -> np.ndarray:
    """Host: cut one tile's mip chain into the unified block run for a slot.

    Returns (total_blocks_per_slot, 32, 128) row-interleaved block quads
    in the attachment dtype, ordered mip-major to match
    :func:`make_patch_plan` offsets.
    """
    out = []
    for m in range(plan.min_mip, plan.max_mip + 1):
        data = mips[m][..., channel]
        g = data.shape[0] // BLOCK
        blocks = (
            data.reshape(g, BLOCK, g, BLOCK).transpose(0, 2, 1, 3).reshape(-1, BLOCK, BLOCK)
        )
        out.append(quad_rows(blocks, g))
    return np.concatenate(out, axis=0)


def blocks_from_tile_packed(mips: list[np.ndarray], plan: PatchPlan) -> np.ndarray:
    """Host: ALL channels of one tile packed little-endian into ONE int32
    block run (channel c in bits [c*bits, (c+1)*bits)).

    A multi-channel texel is one word in the reference's texture formats
    (Rgba8 = 4 bytes, Rg16 = 2 u16s — src/terrain_data/mod.rs:38-84);
    storing it planar would cost one ~600 us DMA-floor fused-sampler pass
    PER channel (measured, docs/perf_notes.md). Packed, the fused sampler
    fetches once and unpacks in-VMEM.
    """
    channels = mips[0].shape[-1]
    bits = 8 * mips[0].dtype.itemsize
    assert channels * bits <= 32, (channels, bits)
    packed = blocks_from_tile(mips, plan, 0).astype(np.uint32)
    for c in range(1, channels):
        packed |= blocks_from_tile(mips, plan, c).astype(np.uint32) << (bits * c)
    return packed.view(np.int32)




# ---------------------------------------------------------------------------
# Device plan
# ---------------------------------------------------------------------------

# Unique-quad cap of the JAX package's fused kernel schedule (its
# pallas_kernels.U_PAD, a limit of the TPU's scalar memory). Tiles past the
# cap get valid = 0 (height 0). The CUDA kernel has no such limit; the cap
# is kept so both packages give the same frame.
U_PAD = 4096
# tiles per kernel step of the JAX schedule: the plan pads the sorted tile
# list to a multiple of it (rank_lo / rank_hi are per step)
TILES_PER_STEP = 64
_KEY_SENTINEL = 2**31 - 1


@dataclasses.dataclass
class PatchBatch:
    """Per-frame patch-fetch schedule: tiles sorted by quad id.

    The fields match the JAX package's PatchBatch. The CUDA mesh kernel
    reads only ``ids`` and ``geom`` (one quad per tile, straight from
    device memory through L2); ``uq`` / ``slots`` / ``rank_lo`` /
    ``rank_hi`` / ``n_unique`` are the TPU kernel's streaming-cache
    schedule, kept for parity and for a later shared-memory quad cache.
    """

    uq: torch.Tensor  # (U_PAD,) i32 unique quad ids in rank order (clamped valid)
    slots: torch.Tensor  # (Fp,) i32 quad rank per tile (nondecreasing)
    rank_lo: torch.Tensor  # (steps,) i32 first rank touched by each step
    rank_hi: torch.Tensor  # (steps,) i32 last rank touched by each step
    n_unique: torch.Tensor  # (1,) i32
    geom: torch.Tensor  # (Fp, 8) f32: p0x p0y dp valid ratio 0 0 0
    ids: torch.Tensor  # (Fp,) i32 sorted quad ids (clamped valid)


def plan_patch_batch(
    tiles: RefinementOutput,
    uniforms,
    cfg: StaticTerrainConfig,
    plan: PatchPlan,
    n_blocks: int,
    assume_sorted: bool = False,
) -> tuple[RefinementOutput, PatchBatch]:
    """Per-tile atlas lookup + patch geometry + quad-id sort.

    Returns (sorted_tiles: RefinementOutput with (F,) arrays, PatchBatch).
    Dead lanes (>= tile_count) sort to the end under the int32 sentinel key.
    With ``assume_sorted`` the tile list is taken to be in quad-id order for
    this plan already (true for a sibling attachment with the height
    attachment's plan) and the sort is skipped, keeping the row order.
    """
    if cfg.tile_tree_lod:
        raise NotImplementedError("tile_tree_lod is not ported to the torch package yet")
    F = cfg.tile_capacity
    dev = tiles.tile_side.device
    i32 = torch.int32
    t_side = tiles.tile_side[:F]
    t_lod = tiles.tile_lod[:F].clamp(min=0)
    t_xy = tiles.tile_xy[:F]
    zeros_uv = torch.zeros((F, 2), dtype=torch.float32, device=dev)

    # --- per-tile blend target + atlas entry (functions.wgsl:232-246 at
    # tile granularity) ---
    center_uv = torch.full((F, 2), 0.5, dtype=torch.float32, device=dev)
    dist = coords.approximate_view_distance(t_side, t_lod, t_xy, center_uv, uniforms, cfg)
    blend_lod, center_ratio = coords.compute_blend(dist, uniforms, cfg)
    t0 = torch.minimum(blend_lod, t_lod)
    e_lod, e_xy, _ = coords.coordinate_change_lod(
        t_lod, t_xy, zeros_uv, t0.clamp(0, cfg.lod_count - 1)
    )
    a_idx, a_lod = coords.lookup_entries(
        uniforms.entries, t_side, e_lod, e_xy % cfg.tree_size, cfg
    )
    a_lod = torch.where(a_lod < 0, t_lod, a_lod)

    _, _, window_uv = coords.coordinate_change_lod(t_lod, t_xy, zeros_uv, a_lod)
    ids4, p0, dp = patch_geometry(a_idx, t_lod, a_lod, window_uv, plan, cfg)
    lane = torch.arange(F, dtype=i32, device=dev)
    live = lane < tiles.tile_count
    valid = ((a_idx >= 0) & live).to(torch.float32)
    per_vertex = cfg.blend and cfg.blend_per_vertex
    ratio = center_ratio if cfg.blend and not per_vertex else torch.zeros_like(center_ratio)

    # --- sort tiles by quad id; dead lanes to the end ---
    key = torch.where(live, ids4[:, 0], _KEY_SENTINEL).to(i32)
    if assume_sorted:
        s_key, s_side, s_lod, s_x, s_y = key, t_side, t_lod, t_xy[:, 0], t_xy[:, 1]
        s_p0, s_dp, s_valid, s_ratio = p0, dp, valid, ratio
    else:
        s_key, perm = torch.sort(key, stable=True)
        s_side, s_lod, s_x, s_y = t_side[perm], t_lod[perm], t_xy[perm, 0], t_xy[perm, 1]
        s_p0 = p0[perm]
        s_dp, s_valid, s_ratio = dp[perm], valid[perm], ratio[perm]

    # --- quad ranks + unique-id list (rank order) ---
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), s_key[1:] != s_key[:-1]])
    rank = torch.cumsum(first.to(i32), 0, dtype=i32) - 1  # nondecreasing
    n_unique = torch.clamp(rank[-1] + 1, max=U_PAD)
    s_valid = torch.where(rank < U_PAD, s_valid, 0.0)
    rank = torch.clamp(rank, max=U_PAD - 1)
    rank_key = torch.where(first, rank, _KEY_SENTINEL).to(i32)
    _, uq_perm = torch.sort(rank_key, stable=True)
    uq = s_key[uq_perm]
    uq = (uq[:U_PAD] if F > U_PAD else uq).clamp(0, n_blocks - 1)
    if uq.shape[0] < U_PAD:
        uq = torch.cat([uq, torch.zeros(U_PAD - uq.shape[0], dtype=i32, device=dev)])

    # --- pad to the step size (padded lanes repeat the last lane) ---
    T = TILES_PER_STEP
    pad = (-F) % T
    Fp = F + pad
    zero = torch.zeros_like(s_dp)
    geom = torch.stack(
        [s_p0[:, 0], s_p0[:, 1], s_dp, s_valid, s_ratio, zero, zero, zero], dim=-1
    )
    slots = rank
    s_ids = s_key.clamp(0, n_blocks - 1)
    if pad:
        geom = torch.cat([geom, geom[-1:].expand(pad, 8)])
        slots = torch.cat([slots, slots[-1:].expand(pad)])
        s_ids = torch.cat([s_ids, s_ids[-1:].expand(pad)])
    steps = Fp // T
    rank_lo = slots.reshape(steps, T)[:, 0].contiguous()
    rank_hi = slots.reshape(steps, T)[:, -1].contiguous()

    sorted_tiles = RefinementOutput(
        tile_side=s_side,
        tile_lod=torch.where(lane < tiles.tile_count, s_lod, -1),
        tile_xy=torch.stack([s_x, s_y], dim=-1),
        tile_count=tiles.tile_count,
        overflow=tiles.overflow,
    )
    batch = PatchBatch(
        uq=uq, slots=slots, rank_lo=rank_lo, rank_hi=rank_hi,
        n_unique=n_unique.reshape(1), geom=geom.contiguous(), ids=s_ids.contiguous(),
    )
    return sorted_tiles, batch


_BASES: dict = {}


def _bases(plan: PatchPlan, device) -> torch.Tensor:
    """plan.bases as an int32 tensor on ``device``, copied there once."""
    key = (plan.bases, str(device))
    if key not in _BASES:
        _BASES[key] = torch.tensor(plan.bases, dtype=torch.int32).to(device)
    return _BASES[key]


def patch_geometry(
    atlas_index: torch.Tensor,  # (F,) i32 (-1 invalid)
    tile_lod: torch.Tensor,  # (F,) i32
    atlas_lod: torch.Tensor,  # (F,) i32
    window_uv: torch.Tensor,  # (F, 2) f32 — window origin within the atlas tile
    plan: PatchPlan,
    cfg: StaticTerrainConfig,
):
    """Block ids + sample geometry of each tile's patch window.

    Returns (ids (F, 4) i32 flat block indices tl/tr/bl/br,
    p0 (F, 2) f32 patch-local start, dp (F,) f32 texel step) so that the
    half-grid texel positions within the patch are ``p0 + k * dp``.
    """
    dev = atlas_index.device
    T = plan.texture_size
    log2T = int(math.log2(T))
    d = (tile_lod - atlas_lod).clamp(0, 30)
    m = (log2T - 5 - d).clamp(plan.min_mip, plan.max_mip)

    size_m = torch.full_like(m, T) >> m
    g_m = size_m // BLOCK
    bases = _bases(plan, dev)[m.long()]

    # texture uv of half-grid point k: (window + k/HG * 2^-d) * scale + inset
    # (border-inset transform, attachments.wgsl:7-10)
    scale = (T - 2 * plan.border_size) / T
    inset = plan.border_size / T
    inv_win = torch.exp2(-d.to(torch.float32))
    HG = 2 * cfg.grid_size
    # texel centers at mip m: p = uv * size_m - 0.5
    size_f = size_m.to(torch.float32)
    start = (window_uv * scale + inset) * size_f[..., None] - 0.5  # (F, 2)
    dp = (inv_win / HG) * scale * size_f  # (F,) texel step per half-grid index

    hi = (g_m - 2).clamp(min=0)
    bx = torch.minimum((start[..., 0] / BLOCK).to(torch.int32).clamp(min=0), hi)
    by = torch.minimum((start[..., 1] / BLOCK).to(torch.int32).clamp(min=0), hi)

    # slot-major layout: all blocks of a slot are contiguous (matches the
    # upload path, blocks_from_tile), mips at per-slot offsets plan.bases
    a = atlas_index.clamp(min=0)
    slot_base = a * plan.total_blocks_per_slot + bases
    gm1 = g_m - 1

    def bid(dy, dx):
        return (slot_base + torch.minimum(by + dy, gm1) * g_m
                + torch.minimum(bx + dx, gm1))

    ids = torch.stack([bid(0, 0), bid(0, 1), bid(1, 0), bid(1, 1)], dim=-1)
    p0 = start - torch.stack([bx, by], dim=-1).to(torch.float32) * BLOCK
    return ids, p0, dp


def sample_attachment_vertices(
    block_arrays,  # list per channel of (N, 32, 128) quad block arrays
    tiles: RefinementOutput,  # the frame's quad-id-sorted tile list
    morphed_uv: torch.Tensor,  # (F, G+1, G+1, 2) from the frame's GridMeshOutput
    uniforms,
    cfg: StaticTerrainConfig,
    plan: PatchPlan,
    max_value: float,
    plan_matches_frame: bool = True,
    packed_channels: int = 0,
    packed_bits: int = 0,
) -> torch.Tensor:
    """Sample an attachment at the frame's morphed vertex uvs (the fragment
    stage's attachment fetch, attachments.wgsl:12-43) through the fused
    sampler kernels: one :func:`kernels.attach_sample_fused` launch per
    channel array, or one :func:`kernels.attach_sample_fused_packed` launch
    for ``packed_channels`` channels of ``packed_bits`` bits in one array.
    Returns (F, G+1, G+1, C) f32 in [0, 1].

    The tiles keep the frame's order: the attachment's plan must be the
    height attachment's (``plan_matches_frame``), so that its quad ids are
    sorted in the same order. Another plan (e.g. a border-1 albedo beside a
    border-2 height) needs the JAX package's per-tile fallback sampler,
    which is not ported yet.
    """
    if not plan_matches_frame:
        raise NotImplementedError(
            "an attachment whose patch plan differs from the height attachment's "
            "needs the per-tile fallback sampler, which is not ported yet")
    if cfg.grid_size != 16:
        raise NotImplementedError(
            f"the attachment sampler kernels need grid_size 16, got {cfg.grid_size}")
    F = cfg.tile_capacity
    _, batch = plan_patch_batch(tiles, uniforms, cfg, plan, block_arrays[0].shape[0],
                                assume_sorted=True)
    # attachments sample one data lod: the crossfade column is zero
    geom = batch.geom.clone()
    geom[:, 4] = 0.0
    Fp = batch.ids.shape[0]
    uvs = morphed_uv.permute(0, 3, 1, 2)
    if Fp > F:
        uvs = torch.cat([uvs, uvs.new_zeros((Fp - F,) + uvs.shape[1:])])
    uvs = uvs.contiguous()
    count = tiles.tile_count.reshape(1).to(torch.int32)
    if packed_channels:
        raw = kernels.attach_sample_fused_packed(block_arrays[0], batch.ids, geom, uvs, count,
                                                 packed_channels, packed_bits)
    else:
        raw = torch.cat([kernels.attach_sample_fused(b, batch.ids, geom, uvs, count)
                         for b in block_arrays], dim=1)
    return raw[:F].permute(0, 2, 3, 1) / max_value
