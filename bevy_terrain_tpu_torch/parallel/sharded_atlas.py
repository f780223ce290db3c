"""The block store cut into shards by slot, and the patch fetch over them.

Torch twin of the JAX package's ``parallel/sharded_atlas.py``. There the
(N, 32, 128) block array is spread over a device mesh: every device holds
``ceil(N / n)`` consecutive slot-major blocks (N padded up to a multiple of
n), gathers the requested blocks it owns, with zeros for the rest, and one
``psum`` over the mesh sums the shards' answers. Each block has exactly one
owner, so the sum is the plain gather.

Two forms of each fetch:

* one card (``group=None``): the n shards are n slices of one tensor on
  that card, and the sum over owners is taken there; no bytes move
  between devices;
* a process group (``group``, one rank per card; parallel/launch.py): each
  rank holds its own shard (:func:`shard_range`) and the sum is a
  collective. :func:`fetch_patches_sharded` is the JAX psum fetch (ids
  replicated, one ``all_reduce``); :func:`fetch_view_patches` is the
  multi-view step's exchange (JAX ``parallel/multi_view.py``
  ``fetch_sharded``): one ``all_gather`` of the views' ids, one
  ``reduce_scatter`` that sums and routes each view's patches to its rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_blocks(n_shards: int, block_array: torch.Tensor) -> torch.Tensor:
    """The (N, 32, 128) quad array as (n_shards, ceil(N / n_shards), 32,
    128): shard r holds blocks [r * per_shard, (r + 1) * per_shard), the
    tail padded with zero blocks. A view of ``block_array`` (which the
    atlas updates in place) when N divides by ``n_shards``, else a padded
    copy."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, got {n_shards}")
    N = block_array.shape[0]
    pad = (-N) % n_shards
    if pad:
        zeros = block_array.new_zeros((pad,) + tuple(block_array.shape[1:]))
        block_array = torch.cat([block_array, zeros])
    return block_array.view((n_shards, (N + pad) // n_shards) + tuple(block_array.shape[1:]))


def shard_range(n_blocks: int, n_shards: int, rank: int) -> tuple[int, int]:
    """(first block, blocks per shard) of shard ``rank`` of an
    ``n_blocks`` store: :func:`shard_blocks`'s layout, the last shard's
    tail past ``n_blocks`` being zero padding."""
    per_shard = -(-n_blocks // n_shards)
    return rank * per_shard, per_shard


def _owned(shard: torch.Tensor, ids: torch.Tensor, rank: int) -> torch.Tensor:
    """f32 blocks of ``ids`` (any shape of global block ids) that ``shard``
    (rank ``rank``'s) owns, zeros for the rest: shape ids.shape + (32, 128)."""
    per_shard = shard.shape[0]
    local = ids.long() - rank * per_shard
    owned = (local >= 0) & (local < per_shard)
    v = shard[local.clamp(0, per_shard - 1)].to(torch.float32)
    return torch.where(owned[..., None, None], v, 0.0)


def _patches(quads: torch.Tensor) -> torch.Tensor:
    """(F, 32, 128) row-interleaved quads -> (F, 64, 64) patches."""
    return torch.cat([quads[:, :, :64], quads[:, :, 64:]], dim=-2)


def fetch_patches_sharded(shards: torch.Tensor, ids: torch.Tensor, group=None) -> torch.Tensor:
    """Assemble (F, 64, 64) f32 patches from blocks owned by any shard.

    ``ids``: (F, 1 or 4) int32 global block ids (column 0, the quad, is
    fetched, as ``patch_sampling.fetch_patches`` does). Each shard gathers
    the ids it owns (``local = id - rank * per_shard``), zeros elsewhere,
    and the shards' answers are summed: equal to ``fetch_patches`` on the
    unsharded array, bit for bit.

    ``group=None``: ``shards`` is :func:`shard_blocks`'s (n, per_shard, 32,
    128) array on one device. With a process group: ``shards`` is this
    rank's (per_shard, 32, 128) shard, ``ids`` the same on every rank, and
    one ``all_reduce`` (sum) leaves the patches on every rank."""
    ids = ids[:, 0]
    if group is not None:
        total = _owned(shards, ids, dist.get_rank(group))
        dist.all_reduce(total, group=group)
        return _patches(total)
    total = None
    for rank in range(shards.shape[0]):
        v = _owned(shards[rank], ids, rank)
        total = v if total is None else total + v
    return _patches(total)


def fetch_view_patches(shard: torch.Tensor, ids: torch.Tensor, group) -> torch.Tensor:
    """This rank's view's (F, 64, 64) f32 patches from a store sharded over
    ``group``, one view per rank (the JAX multi-view step's ``fetch_sharded``).

    ``shard``: this rank's (per_shard, 32, 128) shard; ``ids``: (F, 1 or 4)
    int32 global block ids of THIS rank's view, F the same on every rank.
    The quads a view needs lie on every shard, so the views' ids are
    all-gathered ((n, F)), every rank gathers the ids it owns for every
    view (zeros elsewhere: (n, F, 32, 128) f32), and one reduce-scatter
    sums over the ranks and hands view r's (F, 32, 128) to rank r. Each
    block has one owner, so every sum adds a value to zeros: the plain
    gather, bit for bit."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    mine = ids[:, 0].to(torch.int32).contiguous()
    F = mine.shape[0]
    all_ids = mine.new_empty(n * F)
    dist.all_gather_into_tensor(all_ids, mine, group=group)
    v = _owned(shard, all_ids, rank)  # (n * F, 32, 128): view r's requests at rows r*F..
    out = v.new_empty((F,) + tuple(shard.shape[1:]))
    dist.reduce_scatter_tensor(out, v, group=group)
    return _patches(out)
