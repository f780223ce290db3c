"""The block store cut into shards by slot, and the patch fetch over them.

Torch twin of the JAX package's ``parallel/sharded_atlas.py``. There the
(N, 32, 128) block array is spread over a device mesh: every device holds
``ceil(N / n)`` consecutive slot-major blocks (N padded up to a multiple of
n), gathers the requested blocks it owns, with zeros for the rest, and one
``psum`` over the mesh sums the shards' answers. Each block has exactly one
owner, so the sum is the plain gather.

The port runs on one card: the n shards are n slices of one tensor on that
card, and the sum over owners is taken there. Only the arithmetic is
ported (owner mask, clipped gather, sum); no bytes move between devices,
and the JAX package's collective exchange has no counterpart here.
"""

from __future__ import annotations

import torch


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


def fetch_patches_sharded(shards: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Assemble (F, 64, 64) f32 patches from blocks owned by any shard.

    ``shards``: :func:`shard_blocks`'s (n, per_shard, 32, 128) array;
    ``ids``: (F, 1 or 4) int32 global block ids (column 0, the quad, is
    fetched, as ``patch_sampling.fetch_patches`` does). Each shard gathers
    the ids it owns (``local = id - rank * per_shard``), zeros elsewhere,
    and the shards' answers are summed: equal to ``fetch_patches`` on the
    unsharded array, bit for bit."""
    n, per_shard = shards.shape[:2]
    ids = ids[:, 0].long()
    total = None
    for rank in range(n):
        local = ids - rank * per_shard
        owned = (local >= 0) & (local < per_shard)
        v = shards[rank][local.clamp(0, per_shard - 1)].to(torch.float32)
        v = torch.where(owned[:, None, None], v, 0.0)
        total = v if total is None else total + v
    return torch.cat([total[:, :, :64], total[:, :, 64:]], dim=-2)
