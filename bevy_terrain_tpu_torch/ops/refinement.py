"""Level-synchronous UDLOD tile refinement — torch twin of
the JAX package's ``ops/refinement.py`` (refine_tiles.wgsl semantics).

Same two-stage structure as the JAX package, so the emitted list, its
order, ``tile_count`` and ``overflow`` agree exactly:

1. **Dense levels 0..Ld** — every tile of every shallow level in ONE flat
   predicate batch; reachability cascades by 2x mask upsampling; one stable
   3-way sort (emit | frontier | dead) compacts all levels' emissions.
2. **Queue spill beyond Ld** — the still-dividing frontier's children seed
   a two-levels-per-iteration loop (Q parents + 4Q speculative children,
   one stable 4-way sort per iteration).

The spill loop is the JAX ``while_loop`` on ``q_count > 0`` run from the
host: it reads ``q_count`` once per iteration (one device sync). Measured
on an H100 (PERF.md), the stage is bound by the host's kernel launches, so
the device is idle by the time the host asks and the sync costs little;
a fixed trip count of masked iterations, which needs no sync, launched
~2.5x more work on the bench frame (refine 37-42 ms against 14-19 ms).
Dynamic offsets (the JAX ``dynamic_slice`` / ``dynamic_update_slice``) are
device index tensors, ``offset + arange``; the pads that keep those slices
from clamping in JAX are kept, so the two agree lane for lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bevy_terrain_tpu_torch.ops import coords
from bevy_terrain_tpu_torch.ops.params import FrameUniforms, StaticTerrainConfig
from bevy_terrain_tpu_torch.utils import tracing


@dataclasses.dataclass
class RefinementOutput:
    """Compacted final tile list (the reference's ``final_tiles`` buffer +
    indirect vertex count, prepare_prepass.wgsl:38-44).

    Buffers hold ``tile_capacity + queue_capacity`` lanes; lanes beyond
    ``tile_count`` are left over from the append scheme and must be masked.
    """

    tile_side: torch.Tensor  # (F + Q,) i32
    tile_lod: torch.Tensor  # (F + Q,) i32
    tile_xy: torch.Tensor  # (F + Q, 2) i32
    tile_count: torch.Tensor  # () i32
    # () i32 — tiles/children dropped by the static capacity clamps; any
    # nonzero value means geometry was missing this frame
    overflow: torch.Tensor


def should_be_divided(side, lod, xy, uniforms: FrameUniforms, cfg: StaticTerrainConfig):
    """Subdivision predicate (refine_tiles.wgsl:17-22): the view distance to
    the closest point of the tile is below ``subdivision_distance / 2^lod``."""
    uv = coords.compute_subdivision_coordinate(
        side, lod, xy, uniforms.taylor, cfg.origin_lod, cfg.side_count
    )
    view_distance = coords.approximate_view_distance(side, lod, xy, uv, uniforms, cfg)
    return view_distance < uniforms.subdivision_distance / coords.tile_count(lod)


def dense_level_cap(cfg: StaticTerrainConfig, budget: int = 8192) -> int:
    """Deepest lod evaluated densely (the JAX package's rule: the total
    dense lane count stays under ``budget``)."""
    total, k = 0, -1
    while True:
        nxt = total + cfg.side_count * (4 ** (k + 1))
        if nxt > budget or k + 1 >= cfg.refinement_count:
            return k
        total, k = nxt, k + 1


_DENSE_CACHE: dict = {}


def _dense_columns(S: int, Ld: int, device: torch.device):
    """Flat (side, lod, x, y) int32 columns of every tile of levels 0..Ld,
    level-major, built once per (S, Ld, device)."""
    key = (S, Ld, str(device))
    if key not in _DENSE_CACHE:
        offs = [0]
        cols = [[], [], [], []]
        for k in range(Ld + 1):
            c = 1 << k
            grid = np.mgrid[0:S, 0:c, 0:c].astype(np.int32)  # (3, S, c, c)
            cols[0].append(grid[0].reshape(-1))
            cols[1].append(np.full(S * c * c, k, np.int32))
            cols[2].append(grid[2].reshape(-1))
            cols[3].append(grid[1].reshape(-1))
            offs.append(offs[-1] + S * c * c)
        tensors = tuple(
            torch.from_numpy(np.concatenate(c)).to(device) for c in cols
        )
        _DENSE_CACHE[key] = (offs, tensors)
    return _DENSE_CACHE[key]


def _children(side, x, y):
    """4 children per parent, child-major within each parent
    (refine_tiles.wgsl:24-31)."""
    sub = torch.arange(4, dtype=torch.int32, device=side.device)
    c_side = torch.repeat_interleave(side, 4)
    c_x = ((x[:, None] << 1) + (sub & 1)[None, :]).reshape(-1)
    c_y = ((y[:, None] << 1) + (sub >> 1)[None, :]).reshape(-1)
    return c_side, c_x, c_y


def _stable_sort(key, *cols):
    """Stable sort of int32 ``key`` carrying ``cols`` (the multi-operand
    ``lax.sort(num_keys=1, is_stable=True)``)."""
    s_key, perm = torch.sort(key, stable=True)
    return (s_key,) + tuple(c[perm] for c in cols)


def _queue_left(q_count: torch.Tensor) -> bool:
    """Whether the spill queue holds a tile: a synchronous read of the
    device (the tracing counter ``refine_reads``)."""
    tracing.count("refine_reads")
    return int(q_count) > 0


def refine_tiles(uniforms: FrameUniforms, cfg: StaticTerrainConfig) -> RefinementOutput:
    """Run the full refinement: seed roots, iterate subdivision, compact.

    Root seeding mirrors prepare_prepass.wgsl:4-23; the iteration count
    mirrors the host dispatch loop (tiling_prepass.rs:248-263). On the last
    pass still-subdividing parents are emitted instead of dropped.
    """
    Q = cfg.queue_capacity
    F = cfg.tile_capacity
    Ld = dense_level_cap(cfg)
    S = cfg.side_count
    dev = uniforms.entries.device
    i32 = torch.int32

    def full(n, v):
        return torch.full((n,), v, dtype=i32, device=dev)

    # ---- dense levels 0..Ld: ONE flat predicate batch ----
    offs, (flat_side, flat_lod, flat_x, flat_y) = _dense_columns(S, Ld, dev)
    flat_xy = torch.stack([flat_x, flat_y], dim=-1)
    n_dense = flat_side.shape[0]

    if cfg.culling:
        flat_visible = coords.tile_visible(flat_side, flat_lod, flat_xy, uniforms, cfg)
    else:
        flat_visible = torch.ones(n_dense, dtype=torch.bool, device=dev)
    flat_should = should_be_divided(flat_side, flat_lod, flat_xy, uniforms, cfg) & (
        flat_lod + 1 < cfg.refinement_count
    )

    # reachability cascade: a tile is considered iff all ancestors divided
    emit_flags = []
    reached = torch.ones((S, 1, 1), dtype=torch.bool, device=dev)
    frontier = None
    for k in range(Ld + 1):
        c = 1 << k
        sl = slice(offs[k], offs[k + 1])
        active = reached & flat_visible[sl].reshape(S, c, c)
        divide = flat_should[sl].reshape(S, c, c) & active
        emit_flags.append((active & ~divide).reshape(-1))
        if k == Ld:
            frontier = divide
        else:
            reached = divide.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    # 3-way category: 0 = emit, 1 = frontier parent (deepest dense level),
    # 2 = dead; ONE stable sort yields the emitted prefix (level-major, the
    # queue algorithm's append order) and the frontier block after it
    flat_emit = torch.cat(emit_flags)
    is_front = torch.zeros(n_dense, dtype=torch.bool, device=dev)
    is_front[offs[Ld]:] = frontier.reshape(-1)
    all_cat = torch.where(flat_emit, 0, torch.where(is_front, 1, 2)).to(i32)
    _, s_side, s_lod, s_x, s_y = _stable_sort(all_cat, flat_side, flat_lod, flat_x, flat_y)
    n_emit = (all_cat == 0).sum(dtype=i32)

    w = min(F + Q, n_dense)
    lane_w = torch.arange(w, dtype=i32, device=dev)
    final_side = full(F + Q, 0)
    final_lod = full(F + Q, -1)
    final_x = full(F + Q, 0)
    final_y = full(F + Q, 0)
    final_side[:w] = s_side[:w]
    final_lod[:w] = torch.where(lane_w < n_emit, s_lod[:w], -1)
    final_x[:w] = s_x[:w]
    final_y[:w] = s_y[:w]
    final_count = torch.clamp(n_emit, max=F)
    overflow0 = torch.clamp(n_emit - F, min=0)

    # ---- spill: the frontier parents are the category-1 block of the
    # sorted columns, at device offset n_emit (zero-padded so the window
    # never runs off the end, as the JAX dynamic_slice pads) ----
    n_front = frontier.sum(dtype=i32)
    take = max(1, Q // 4)
    win = n_emit.long() + torch.arange(take, device=dev)

    def window(col):
        return torch.cat([col, full(take, 0)])[win]

    c_side, c_x, c_y = _children(window(s_side), window(s_x), window(s_y))
    pad_q = Q - c_side.shape[0]
    if pad_q > 0:
        c_side, c_x, c_y = (torch.cat([c, full(pad_q, 0)]) for c in (c_side, c_x, c_y))
    qcols = torch.stack([c_side[:Q], c_x[:Q], c_y[:Q]])  # (3, Q)
    q_count = torch.clamp(4 * n_front, max=Q)
    overflow0 = overflow0 + torch.clamp(4 * n_front - Q, min=0)

    L = 5 * Q  # merged batch: Q parents + 4Q speculative children
    lane_q = torch.arange(Q, dtype=i32, device=dev)
    lane_l = torch.arange(L, dtype=i32, device=dev)
    is_child = lane_l >= Q
    fbuf = torch.zeros((4, F + L), dtype=i32, device=dev)
    fbuf[1] = -1
    fbuf[:, :F + Q] = torch.stack([final_side, final_lod, final_x, final_y])
    f_count = final_count
    dropped = overflow0
    k = Ld + 1

    # the JAX while_loop's condition; int(q_count) is the one device read
    while k < cfg.refinement_count and _queue_left(q_count):
        q_side, q_x, q_y = qcols[0], qcols[1], qcols[2]
        ch_side, ch_x, ch_y = _children(q_side, q_x, q_y)
        b_side = torch.cat([q_side, ch_side])
        b_x = torch.cat([q_x, ch_x])
        b_y = torch.cat([q_y, ch_y])
        b_lod = k + is_child.to(i32)
        b_xy = torch.stack([b_x, b_y], dim=-1)

        # ONE predicate batch for both levels
        if cfg.culling:
            vis = coords.tile_visible(b_side, b_lod, b_xy, uniforms, cfg)
        else:
            vis = torch.ones(L, dtype=torch.bool, device=dev)
        should = should_be_divided(b_side, b_lod, b_xy, uniforms, cfg)

        active_p = (lane_q < q_count) & vis[:Q]
        div_p = should[:Q] & active_p & (k + 1 < cfg.refinement_count)
        emit_p = active_p & ~div_p
        active_c = div_p.repeat_interleave(4) & vis[Q:]
        div_c = should[Q:] & active_c & (k + 2 < cfg.refinement_count)
        emit_c = active_c & ~div_c

        # stable partition: parent emits (0) | child emits (1) | divided
        # children (2) | dead (3) — keeps the level-major emit order
        cat_p = torch.where(emit_p, 0, 3)
        cat_c = torch.where(emit_c, 1, torch.where(div_c, 2, 3))
        category = torch.cat([cat_p, cat_c]).to(i32)
        _, s_side, s_x, s_y = _stable_sort(category, b_side, b_x, b_y)
        n_emit_p = emit_p.sum(dtype=i32)
        n_emit = n_emit_p + emit_c.sum(dtype=i32)
        n_div = div_c.sum(dtype=i32)

        # append both levels' emitted prefix at offset min(f_count, F) (the
        # non-emitted tail written here is overwritten by later appends)
        lodvec = k + (lane_l >= n_emit_p).to(i32)
        srows = torch.stack([s_side, lodvec, s_x, s_y])  # (4, L)
        dst = (torch.clamp(f_count, max=F).long() + lane_l.long())[None, :].expand(4, L)
        fbuf.scatter_(1, dst, srows)
        dropped = dropped + torch.clamp(f_count + n_emit - F, min=0)
        f_count = torch.clamp(f_count + n_emit, max=F)

        # next queue: the divided-children block (sorted rows
        # [n_emit, n_emit + n_div)) expanded to their level-(k+2) children
        gwin = n_emit.long() + torch.arange(Q, device=dev)
        padded = torch.cat(
            [torch.stack([s_side, s_x, s_y]), torch.zeros((3, Q), dtype=i32, device=dev)],
            dim=1,
        )  # (3, L + Q)
        gpar = padded[:, gwin]
        g_side, g_x, g_y = _children(gpar[0], gpar[1], gpar[2])
        qcols = torch.stack([g_side[:Q], g_x[:Q], g_y[:Q]])
        dropped = dropped + torch.clamp(4 * n_div - Q, min=0)
        q_count = torch.clamp(4 * n_div, max=Q)
        k += 2

    return RefinementOutput(
        tile_side=fbuf[0, :F + Q],
        tile_lod=fbuf[1, :F + Q],
        tile_xy=torch.stack([fbuf[2, :F + Q], fbuf[3, :F + Q]], dim=-1),
        tile_count=f_count,
        overflow=dropped,
    )
