"""Gather-based patch plan: per-tile atlas lookup, patch geometry, the
quad-sorted fetch schedule and the staged half-grid functions — torch twin
of the JAX package's ``ops/patch_sampling.py``.

Each tile of a frame samples ONE 16 KB quad of 2x2 texel blocks of its
atlas tile's mip chain (the quad covers the tile's uv window at the mip
whose texel density matches the vertex half-grid). The host block
builders (:func:`quad_rows`, :func:`blocks_from_tile`) are copied from the
JAX package unchanged; :func:`plan_patch_batch` computes the same
:class:`PatchBatch` on the device with torch ops, field for field.

The half-grid functions (:func:`fetch_patches`, :func:`halfgrid_resample`,
:func:`smooth_halfgrid`, :func:`permute_halfgrid`,
:func:`smooth_halfgrid_permuted`, :func:`vertex_values_from_halfgrid`) are
the staged path for any grid size, and :func:`grad_tile_span` /
:func:`sample_attachment_vertices_grad` the multi-tap gradient sampler on
top of them: plain torch ops, as the JAX package leaves them to XLA. Their matrix products run in full f32 whatever the
process-wide TF32 switch says (:func:`full_f32_matmul`): a TF32 product
would quantise 16-bit heights to 11 bits.
"""

from __future__ import annotations

import contextlib
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
    if cfg.tile_tree_lod:
        # TILE_TREE_LOD (functions.wgsl:232-246, the #ifdef branch): the
        # deepest tree window containing the tile centre instead of the
        # computed blend lod (a debug mode)
        _, walk_lod, _, _ = coords.lookup_best(
            uniforms.entries, uniforms.origins, t_side, t_lod, t_xy, center_uv, cfg)
        t0 = torch.minimum(walk_lod, t_lod)
    else:
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


# ---------------------------------------------------------------------------
# Staged half-grid functions (any grid size)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32_matmul():
    """Run the enclosed CUDA matrix products in full f32: TF32 off for the
    block, the caller's setting restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def fetch_patches(block_array: torch.Tensor, ids: torch.Tensor,
                  keep_int: bool = False) -> torch.Tensor:
    """Staged patch assembly: one quad gather per tile, (F, 64, 64) in
    natural texel order (the JAX package's fetch_patches_xla).

    ``block_array`` is (N, 32, 128) quad storage (:func:`quad_rows`); only
    column 0 of ``ids`` (F, 1 or 4) is fetched, the quad holds the other
    three blocks. ``keep_int`` keeps the int32 words of a packed
    multi-channel array (the caller unpacks, then casts)."""
    q = block_array[ids[:, 0].long()]  # (F, 32, 128)
    if not keep_int:
        q = q.to(torch.float32)
    return torch.cat([q[:, :, :64], q[:, :, 64:]], dim=-2)


def halfgrid_resample(patch: torch.Tensor, p0: torch.Tensor, dp: torch.Tensor,
                      cfg: StaticTerrainConfig, ratio=None) -> torch.Tensor:
    """Exact bilinear of the patch at the (HG+1)^2 half-grid points, as two
    batched tent-weight matrix products. Returns (F, HG+1, HG+1) f32 raw
    texel values in natural order.

    With ``ratio`` (per-tile blend fraction toward the coarser data lod) the
    tent weights are crossfaded toward their 1-2-1 form ``0.25 t(p - dp) +
    0.5 t(p) + 0.25 t(p + dp)`` (the boundary rows keep ``t(p)``), so the
    coarse sample costs no further products."""
    K = 2 * cfg.grid_size + 1
    k = torch.arange(K, dtype=torch.float32, device=patch.device)
    r = torch.arange(64, dtype=torch.float32, device=patch.device)

    def tents(start, koff):
        p = (start[:, None] + (k[None, :] + koff) * dp[:, None]).clamp(0.0, 63.0)
        return (1.0 - torch.abs(p[..., None] - r)).clamp(min=0.0)  # (F, K, 64)

    def weights(start):
        w = tents(start, 0.0)
        if ratio is None:
            return w
        wm = torch.where((k == 0)[None, :, None], w, tents(start, -1.0))
        wp = torch.where((k == K - 1)[None, :, None], w, tents(start, 1.0))
        w2 = 0.25 * wm + 0.5 * w + 0.25 * wp
        return w + (w2 - w) * ratio[:, None, None]

    wx = weights(p0[:, 0])
    wy = weights(p0[:, 1])
    with full_f32_matmul():
        rows = torch.einsum("fkp,fpq->fkq", wy, patch)
        return torch.einsum("fkq,flq->fkl", rows, wx)


def smooth_halfgrid(half: torch.Tensor) -> torch.Tensor:
    """1-2-1 separable smoothing with duplicated boundary rows, about the
    next-coarser mip's bilinear: the blend's coarse sample."""

    def smooth_axis(x, axis):
        n = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
        hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
        return 0.25 * lo + 0.5 * x + 0.25 * hi

    return smooth_axis(smooth_axis(half, 1), 2)


def halfgrid_perm(K: int) -> np.ndarray:
    """Evens-first half-grid index order [0, 2, .., 1, 3, ..] (see _window9)."""
    return np.concatenate([np.arange(0, K, 2), np.arange(1, K, 2)])


def permute_halfgrid(half: torch.Tensor) -> torch.Tensor:
    """A natural (F, K, K) half-grid in evens-first rows and columns (the
    order kernels.fetch_resample_cached writes and _window9 reads)."""
    p = torch.from_numpy(halfgrid_perm(half.shape[-1])).to(half.device)
    return half[:, p][:, :, p]


def smooth_halfgrid_permuted(half_p: torch.Tensor) -> torch.Tensor:
    """:func:`smooth_halfgrid` on an evens-first half-grid: two batched
    products with the permuted 1-2-1 matrix (equal up to f32 summation
    order)."""
    K = half_p.shape[-1]
    A = np.zeros((K, K), np.float32)
    for i in range(K):
        A[i, max(i - 1, 0)] += 0.25
        A[i, i] += 0.5
        A[i, min(i + 1, K - 1)] += 0.25
    p = halfgrid_perm(K)
    Ap = torch.from_numpy(A[np.ix_(p, p)]).to(half_p.device)
    with full_f32_matmul():
        out = torch.einsum("kl,fln->fkn", Ap, half_p)
        return torch.einsum("fkn,ln->fkl", out, Ap)


def _window9(half_p: torch.Tensor, G: int) -> dict:
    """The nine terms of the per-vertex 3x3 windows of an evens-first half
    grid. Vertex i's window covers the natural half-grid indices
    {max(2i - 2, 0) + b}; evens-first these are unit-stride slices of the
    even block (b = 0: e[max(i - 1, 0)], b = 2: e[i]) and of the odd block
    (b = 1: o[i - 1], e[0] at i = 0). Returns {(b, a): (F, G+1, G+1)}."""
    E = G + 1  # even block size

    def sel(x, axis, o):
        if o == 2:  # natural {0, 2, .., 2G} -> e[0..G]
            return x.narrow(axis, 0, G + 1)
        # o == 0: natural {0, 0, 2, .., 2G-2} -> e[0], e[0..G-1]
        # o == 1: natural {0, 1, 3, .., 2G-1} -> e[0], o[0..G-1]
        body = x.narrow(axis, 0 if o == 0 else E, G)
        return torch.cat([x.narrow(axis, 0, 1), body], dim=axis)

    return {(b, a): sel(sel(half_p, 2, a), 1, b) for b in range(3) for a in range(3)}


def vertex_values_from_halfgrid(half_p: torch.Tensor, morphed_uv: torch.Tensor,
                                cfg: StaticTerrainConfig) -> torch.Tensor:
    """Interpolate half-grid values at morphed vertex uvs.

    ``half_p``: (F, HG+1, HG+1) in evens-first order (:func:`permute_halfgrid`
    or kernels.fetch_resample_cached). ``morphed_uv``: (F, G+1, G+1, 2) with
    u in [even_u, u] per vertex. Returns (F, G+1, G+1) f32."""
    G = cfg.grid_size
    HG = 2 * G
    win = _window9(half_p, G)
    i = torch.arange(G + 1, device=half_p.device)
    xbase = (2 * i - 2).clamp(min=0).to(torch.float32)
    lx = morphed_uv[..., 0] * HG - xbase[None, None, :]
    ly = morphed_uv[..., 1] * HG - xbase[None, :, None]

    value = None
    for (b, a), term in win.items():
        w = (1.0 - torch.abs(ly - b)).clamp(min=0.0) * (1.0 - torch.abs(lx - a)).clamp(min=0.0)
        value = w * term if value is None else value + w * term
    return value


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
    stage's attachment fetch, attachments.wgsl:12-43). Returns (F, G+1, G+1,
    C) f32 in [0, 1].

    The tiles keep the frame's order. When the attachment's plan is the
    height attachment's (``plan_matches_frame``, the common case) its quad
    ids are sorted in the same order, and with ``cfg.pallas_sampling`` at
    grid size 16 the fused sampler kernels run: one
    :func:`kernels.attach_sample_fused` launch per channel array, or one
    :func:`kernels.attach_sample_fused_packed` launch for
    ``packed_channels`` channels of ``packed_bits`` bits in one array.
    Another plan (e.g. a border-1 albedo beside a border-2 height), another
    grid size or the switch off takes the staged sampler per channel:
    :func:`fetch_patches`, :func:`halfgrid_resample`,
    :func:`vertex_values_from_halfgrid`.
    """
    F = cfg.tile_capacity
    _, batch = plan_patch_batch(tiles, uniforms, cfg, plan, block_arrays[0].shape[0],
                                assume_sorted=True)
    if not (cfg.pallas_sampling and plan_matches_frame and cfg.grid_size == 16):
        ids = batch.ids[:F, None]
        p0, dp, valid = batch.geom[:F, 0:2], batch.geom[:F, 2], batch.geom[:F, 3]

        def staged_channel(patch):
            half = halfgrid_resample(patch, p0, dp, cfg) / max_value
            half = permute_halfgrid(half * valid[:, None, None])
            return vertex_values_from_halfgrid(half, morphed_uv, cfg)

        if packed_channels:
            packed = fetch_patches(block_arrays[0], ids, keep_int=True)
            return torch.stack(
                [staged_channel(kernels.unpack(packed, c, packed_bits).to(torch.float32))
                 for c in range(packed_channels)], dim=-1)
        return torch.stack([staged_channel(fetch_patches(b, ids)) for b in block_arrays],
                           dim=-1)
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


def grad_tile_span(mesh, uniforms, cfg: StaticTerrainConfig,
                   max_anisotropy: float = 16.0) -> torch.Tensor:
    """Per-tile anisotropic footprint, the SAMPLE_GRAD answer for colour
    attachments (reference attachments.wgsl:12-24, textureSampleGrad with
    anisotropy 16).

    The reference's footprint is the screen-pixel preimage, elongated at
    grazing angles along the view direction's surface projection. On the
    vertex grid: project the view ray onto the surface tangent plane,
    express that direction in tile-uv space through the grid's own
    world-per-uv Jacobian (finite differences, no extra fetches), and
    stretch it by tan(theta) = |tangential| / (view . normal), clamped to
    ``max_anisotropy``. The isotropic unit is the half-grid sample spacing
    1 / (2 G), the density the mip selection pins to (:func:`patch_geometry`).
    The per-vertex spans are reduced to one span per tile (grid mean); the
    taps are applied at the half-grid resample
    (:func:`sample_attachment_vertices_grad`).

    Returns (F, 2) f32: the footprint's full extent in tile-uv units, along
    the view's surface projection.
    """
    pos = mesh.positions  # (F, G1, G1, 3)
    n = mesh.normals

    def diff(x, axis):
        size = x.shape[axis]
        lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, size - 1)], dim=axis)
        hi = torch.cat([x.narrow(axis, 1, size - 1), x.narrow(axis, size - 1, 1)], dim=axis)
        return (hi - lo) * 0.5

    def norm(x):
        return coords.norm3(x)[..., None]

    # world-per-uv Jacobian columns from the grid itself (du along columns,
    # dv along rows; grid spacing = 1 / G in uv)
    G = cfg.grid_size
    xu = diff(pos, 2) * G  # d(world) / d(u)
    xv = diff(pos, 1) * G
    v = uniforms.view_world_position - pos
    v = v / norm(v).clamp(min=1e-8)
    vn = torch.sum(v * n, dim=-1, keepdim=True)
    t = v - vn * n  # tangential view component
    tlen = norm(t)
    aniso = (tlen / vn.abs().clamp(min=1e-3)).clamp(max=max_anisotropy)
    tdir = t / tlen.clamp(min=1e-8)
    # uv direction of the tangential view ray (the grid axes are near-orthogonal)
    du = torch.sum(tdir * xu, dim=-1) / torch.sum(xu * xu, dim=-1).clamp(min=1e-12)
    dv = torch.sum(tdir * xv, dim=-1) / torch.sum(xv * xv, dim=-1).clamp(min=1e-12)
    d_uv = torch.stack([du, dv], dim=-1)
    d_uv = d_uv / torch.sqrt(du * du + dv * dv)[..., None].clamp(min=1e-8)
    sample_spacing = 1.0 / (2.0 * G)  # half-grid spacing in tile uv
    span = d_uv * (aniso * sample_spacing)  # the full anisotropic footprint
    return span.mean(dim=(1, 2))  # (F, 2) per tile


def sample_attachment_vertices_grad(
    block_arrays, tiles: RefinementOutput, morphed_uv: torch.Tensor, mesh, uniforms,
    cfg: StaticTerrainConfig, plan: PatchPlan, max_value: float, taps: int = 4,
    plan_matches_frame: bool = True, max_anisotropy: float = 16.0, packed_channels: int = 0,
    packed_bits: int = 0,
) -> torch.Tensor:
    """Grad-weighted multi-tap attachment sampling (the textureSampleGrad
    equivalent; see :func:`grad_tile_span`): each tap shifts the half-grid
    resample's patch-texel start along the per-tile anisotropy axis, and the
    taps are averaged: a box filter along the grazing direction.

    The patch fetch is shared across taps; per tap the cost is one half-grid
    resample and one window interpolation. Always the staged sampler (the
    sampler kernels bake single-tap geometry), as in the JAX package, so
    it serves an attachment of any patch plan: ``plan_matches_frame`` is
    accepted and changes nothing, as in the JAX function. Returns (F, G+1,
    G+1, C) f32 in [0, 1].
    """
    F = cfg.tile_capacity
    _, batch = plan_patch_batch(tiles, uniforms, cfg, plan, block_arrays[0].shape[0],
                                assume_sorted=True)
    ids = batch.ids[:F, None]
    p0, dp, valid = batch.geom[:F, 0:2], batch.geom[:F, 2], batch.geom[:F, 3]
    # a tile-uv offset du maps to texels as du * HG * dp (half-grid index k
    # is tile-uv k / HG and sits at texel p0 + k * dp, patch_geometry)
    HG = 2 * cfg.grid_size
    span_tex = grad_tile_span(mesh, uniforms, cfg, max_anisotropy) * (HG * dp)[:, None]
    ks = (np.arange(taps, dtype=np.float32) + 0.5) / taps - 0.5

    def tap_channel(patch):
        acc = None
        for k in ks:
            half = halfgrid_resample(patch, p0 + float(k) * span_tex, dp, cfg) / max_value
            half = permute_halfgrid(half * valid[:, None, None])
            v = vertex_values_from_halfgrid(half, morphed_uv, cfg)
            acc = v if acc is None else acc + v
        return acc / taps

    if packed_channels:
        packed = fetch_patches(block_arrays[0], ids, keep_int=True)
        return torch.stack(
            [tap_channel(kernels.unpack(packed, c, packed_bits).to(torch.float32))
             for c in range(packed_channels)], dim=-1)
    return torch.stack([tap_channel(fetch_patches(b, ids)) for b in block_arrays], dim=-1)
