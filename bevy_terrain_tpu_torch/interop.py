"""Carry state into this package as numpy: uniform blobs and atlases.

The two packages never import each other; a caller that holds both (the
parity tests) converts the JAX side's arrays with ``np.asarray`` and hands
them over here, so both packages compute on identical state. The pipeline
uploads its own blob through :func:`blob_to_device` too.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
from bevy_terrain_tpu_torch.terrain_data import attachment as attachment_io
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas, TileAtlasState, _TileState


def blob_to_device(blob: np.ndarray, device) -> torch.Tensor:
    """A packed uniform blob (params.pack_frame_uniforms layout) as an int32
    tensor on ``device``. A CUDA copy goes from pinned memory, without
    waiting for the device (the caching host allocator keeps the pinned
    buffer alive until the copy has run)."""
    t = torch.from_numpy(np.array(blob, np.int32))  # a writable host copy
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def atlas_from_numpy(atlas: TileAtlas, block_arrays, host_data, tile_states) -> TileAtlas:
    """Fill ``atlas`` with another atlas's contents and residency.

    Args:
      block_arrays: per attachment, the (N, 32, 128) int32 block-quad array
        (e.g. ``np.asarray(jax_atlas.attachments[0].block_array)``), or the
        JAX attachment's ``block_arrays`` list, or None. A multi-channel
        attachment (Rgba8, Rg16) has one array of packed words in both
        packages.
      host_data: per attachment, the list of resident mip-0 payloads per
        atlas slot (None where empty); the mip slabs are rebuilt from them.
      tile_states: mapping ``(side, lod, x, y) -> (atlas_index, requests,
        loading_remaining)`` of the resident tiles.

    Pending loads and staged uploads are dropped. The native runtime's
    residency machine cannot be handed slots, so the atlas gets a new
    ``TileAtlasState(use_native=False)``: the Python machine, the oracle
    the native one is fuzzed against, from here on. Returns ``atlas``.
    """
    for att, blocks, data in zip(atlas.attachments, block_arrays, host_data):
        if isinstance(blocks, (list, tuple)):
            if len(blocks) != 1:
                raise ValueError(f"attachment {att.name!r} stores one block array, "
                                 f"got {len(blocks)}")
            blocks = blocks[0]
        if blocks is not None:
            if att.block_array is None or tuple(blocks.shape) != tuple(att.block_array.shape):
                raise ValueError(
                    f"block array of shape {tuple(blocks.shape)} does not fit "
                    f"attachment {att.name!r}")
            att.block_array.copy_(torch.from_numpy(np.array(blocks, np.int32)))
        if len(data) != atlas.atlas_size:
            raise ValueError(f"host data has {len(data)} slots, atlas {atlas.atlas_size}")
        att._staged.clear()
        att.loading.clear()
        att.upload_slabs([
            (index, attachment_io.generate_mipmaps(np.asarray(d), att.config.mip_level_count))
            for index, d in enumerate(data) if d is not None])
        att.data = [None if d is None else np.asarray(d) for d in data]

    state = atlas.state = TileAtlasState(atlas.atlas_size, len(atlas.attachments),
                                         atlas.state.existing_tiles, use_native=False)
    for (side, lod, x, y), (index, requests, loading) in tile_states.items():
        coordinate = TileCoordinate(int(side), int(lod), int(x), int(y))
        state.tile_states[coordinate] = _TileState(int(index), int(requests), int(loading))
        state.existing_tiles.add(coordinate)
        if requests > 0:
            state.unused_tiles.pop(int(index), None)
        else:
            state.unused_tiles[int(index)] = coordinate
    return atlas
