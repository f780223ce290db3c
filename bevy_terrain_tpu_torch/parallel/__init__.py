"""Several views over one shared atlas, and the atlas's block store in
shards: the torch twin of the JAX package's ``parallel/``.

The reference's only "multi" dimension is N views sharing one TileAtlas
through request counting (terrain_view.rs:6-7). The JAX package spreads it
over a device mesh; the port steps it on one card, or one view per card
over a ``torch.distributed`` process group:

* :mod:`multi_view`: N distinct views, each with its own request scan
  against the shared atlas and its own device step; their products stacked
  along a leading views axis (one card), or each on its rank's card;
* :mod:`sharded_atlas`: the block store cut into slot-major shards, and the
  patch fetch as a sum over the shards' owned blocks (on one card, or as
  collectives over the group);
* :mod:`launch`: one process per card, joined in a group;
* :mod:`collective_audit`: the collectives of a step, read from a profiler
  trace (the twin of the JAX package's HLO audit).
"""

from bevy_terrain_tpu_torch.parallel.launch import launch
from bevy_terrain_tpu_torch.parallel.multi_view import (
    MultiViewTerrain,
    multi_view_frame_step,
)
from bevy_terrain_tpu_torch.parallel.sharded_atlas import (
    fetch_patches_sharded,
    fetch_view_patches,
    shard_blocks,
    shard_range,
)

__all__ = [
    "MultiViewTerrain",
    "fetch_patches_sharded",
    "fetch_view_patches",
    "launch",
    "multi_view_frame_step",
    "shard_blocks",
    "shard_range",
]
