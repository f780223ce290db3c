"""The TileAtlas: sparse streaming store of terrain attachment tiles.

Torch twin of the JAX package's ``terrain_data/tile_atlas.py`` (behavioral
twin of the reference's ``TileAtlas``, tile_atlas.rs):

* **Residency state machine (host)** — ``TileAtlasState``, copied from the
  JAX package: request-counted tiles, FIFO of unused slots as LRU cache,
  bounded load/save slot budgets, best-loaded-ancestor lookup; every
  transition mirrored into the native runtime's machine
  (native/terrain_runtime.cpp), which walks the best tiles.
* **Async file IO (host)** — thread-pool load/save of raw ``.bin`` tile
  payloads with mip generation at load. The pool only reads files and
  builds numpy mips; device uploads happen in :meth:`TileAtlas.flush_uploads`
  on the thread that calls it (the one that owns the CUDA stream).
* **Device storage** — per attachment ONE ``(atlas_size * 84, 32, 128)``
  int32 block-quad tensor (patch_sampling.quad_rows) on the atlas's
  device, updated by one ``index_copy_`` per frame; a multi-channel format
  (Rgba8, Rg16) packs its channels into each int32 word
  (patch_sampling.blocks_from_tile_packed). Beside it one slab per mip,
  ``(atlas_size, size >> m, size >> m, channels)`` in the attachment's
  native integer dtype, which the per-vertex mesh path gathers from
  (ops/sampling.py).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from collections import OrderedDict, deque
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig
from bevy_terrain_tpu_torch.formats.tc import TC
from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
from bevy_terrain_tpu_torch.ops.patch_sampling import (
    blocks_from_tile, blocks_from_tile_packed, make_patch_plan,
)
from bevy_terrain_tpu_torch.terrain_data import attachment as attachment_io
from bevy_terrain_tpu_torch.utils import tracing

INVALID_ATLAS_INDEX = -1
INVALID_LOD = -1

_SLAB_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16}

# Slot budgets (reference tile_atlas.rs:318-323).
DEFAULT_LOAD_SLOTS = 64
DEFAULT_SAVE_SLOTS = 64
DEFAULT_DOWNLOAD_SLOTS = 128
DEFAULT_ATLAS_WRITE_SLOTS = 32

# key packing for vectorized ancestor search: side(3b) lod(5b) x(26b) y(26b)
_LOD_SHIFT = 52
_X_SHIFT = 26
_SIDE_SHIFT = 57


def pack_keys(side, lod, x, y) -> np.ndarray:
    """Pack tile coordinates into sortable int64 keys (lod <= 26)."""
    return (
        (np.asarray(side, np.int64) << _SIDE_SHIFT)
        | (np.asarray(lod, np.int64) << _LOD_SHIFT)
        | (np.asarray(x, np.int64) << _X_SHIFT)
        | np.asarray(y, np.int64)
    )


def apply_block_uploads(store: torch.Tensor, slots: torch.Tensor, words: torch.Tensor,
                        per_slot: int, first: int | None = None) -> None:
    """Write uploaded quads (:meth:`AtlasAttachment.take_block_uploads`,
    ``slots`` and ``words`` as tensors on ``store``'s device) into a block
    store: the whole (N, 32, 128) array (``first=None``), or the shard of
    it that holds global blocks [first, first + store.shape[0]), which
    keeps only the quads it owns. One ``index_copy_``."""
    if slots.numel() == 0:
        return
    block_idx = (slots[:, None] * per_slot
                 + torch.arange(per_slot, device=slots.device)[None, :]).reshape(-1)
    if first is not None:
        local = block_idx - first
        keep = (local >= 0) & (local < store.shape[0])
        block_idx, words = local[keep], words[keep]
    store.index_copy_(0, block_idx, words)


@dataclasses.dataclass
class _TileState:
    """Residency record (reference tile_atlas.rs:272-280)."""

    atlas_index: int
    requests: int
    loading_remaining: int  # 0 == Loaded; else Loading(n) (tile_atlas.rs:264-270)


class AtlasAttachment:
    """One attachment of the atlas: host payloads + device mip slabs and
    block quads + IO.

    Mirrors ``AtlasAttachment`` (tile_atlas.rs:153-258) with the GPU side of
    ``GpuAtlasAttachment`` (gpu_tile_atlas.rs:180-347) folded in.
    """

    def __init__(self, config: AttachmentConfig, atlas_size: int, path: str,
                 device: torch.device, assets_root: str = "assets"):
        self.config = config
        self.name = config.name
        # {assets_root}/{path}/data/{name} (reference tile_atlas.rs:174)
        self.path = f"{assets_root}/{path}/data/{config.name}"
        self.atlas_size = atlas_size
        self.device = torch.device(device)
        # host mirror of resident payloads (mip 0), for CPU sampling + saving
        self.data: list[Optional[np.ndarray]] = [None] * atlas_size
        # device slabs per mip
        fmt = config.format
        self.slabs: list[torch.Tensor] = [
            torch.zeros(
                (atlas_size, config.mip_size(m), config.mip_size(m), fmt.channels),
                dtype=_SLAB_DTYPES[fmt.dtype], device=self.device,
            )
            for m in range(config.mip_level_count)
        ]
        # unified blocked mip array for the patch sampler
        # (ops/patch_sampling.py); None when the attachment is too small
        self.patch_plan = make_patch_plan(
            config.texture_size, config.mip_level_count, config.border_size
        )
        # A multi-channel format stores ONE packed int32 block array (channel
        # c in bits [c*B, (c+1)*B), B = 8 or 16): a texel is one word, as in
        # the reference's texture formats (src/terrain_data/mod.rs:38-84), so
        # one quad fetch serves every channel
        self.block_packed = config.format.channels > 1
        self.packed_bits = 8 * config.format.dtype.itemsize if self.block_packed else 0
        self.block_arrays: Optional[list[torch.Tensor]] = None
        if self.patch_plan.usable:
            # int32 row-interleaved block quads (32, 128), slot-major:
            # slot a's blocks are rows [a * per_slot, (a + 1) * per_slot)
            shape = (atlas_size * self.patch_plan.total_blocks_per_slot, 32, 128)
            self.block_arrays = [torch.zeros(shape, dtype=torch.int32, device=self.device)]
        # staged uploads: (atlas_index, [mip arrays])
        self._staged: list[tuple[int, list[np.ndarray]]] = []
        self.loading: list[tuple[Future, "AtlasTileAttachment"]] = []
        self.saving: list[Future] = []

    @property
    def block_array(self) -> Optional[torch.Tensor]:
        """The block array of channel 0 (of every channel when packed)."""
        return self.block_arrays[0] if self.block_arrays else None

    # -- IO (reference tile_atlas.rs:77-149) --

    def start_loading(self, pool: ThreadPoolExecutor, tile: "AtlasTileAttachment"):
        def task():
            path = Path(self.path) / f"{tile.coordinate}.bin"
            raw = path.read_bytes()
            mip0 = attachment_io.data_from_bytes(raw, self.config)
            mips = attachment_io.generate_mipmaps(mip0, self.config.mip_level_count)
            return mips

        self.loading.append((pool.submit(task), tile))

    def start_saving(self, pool: ThreadPoolExecutor, tile: "AtlasTileAttachment"):
        data = self.data[tile.atlas_index]
        if data is None:
            raise ValueError(f"saving tile {tile.coordinate} with no data")
        payload = attachment_io.data_to_bytes(data)

        def task():
            path = Path(self.path) / f"{tile.coordinate}.bin"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(payload)
            return tile

        self.saving.append(pool.submit(task))

    # -- per-frame update (reference tile_atlas.rs:195-224) --

    def update(self, state: "TileAtlasState") -> None:
        still_loading = []
        for fut, tile in self.loading:
            if not fut.done():
                still_loading.append((fut, tile))
                continue
            try:
                mips = fut.result()
            except FileNotFoundError:
                # missing tile file: refund the slot, tile stays unloaded
                # (reference tile_atlas.rs:196-207 Err branch)
                state.load_slots += 1
                continue
            state.loaded_tile_attachment(tile)
            self.data[tile.atlas_index] = mips[0]
            self._staged.append((tile.atlas_index, mips))
        self.loading = still_loading

        still_saving = []
        for fut in self.saving:
            if fut.done():
                fut.result()
                state.saved_tile_attachment()
            else:
                still_saving.append(fut)
        self.saving = still_saving

    def upload_slabs(self, staged) -> None:
        """Copy ``staged`` tiles, (atlas_index, [mip arrays]) each, into the
        device slabs: one host-to-device copy and one ``index_copy_`` per
        mip."""
        if not staged:
            return
        slots = torch.tensor([i for i, _ in staged], dtype=torch.int64).to(self.device)
        tracing.count("upload_bytes", slots.numel() * 8)
        for m, slab in enumerate(self.slabs):
            vals = np.stack([mips[m] for _, mips in staged])
            if slab.dtype == torch.uint16:
                # index_copy_ takes no uint16: write the same bits as int16
                slab, vals = slab.view(torch.int16), vals.view(np.int16)
            tracing.count("upload_bytes", vals.nbytes)
            slab.index_copy_(0, slots, torch.from_numpy(vals).to(self.device))

    def _staged_quads(self) -> tuple[np.ndarray, np.ndarray]:
        """The staged tiles' slots, (k,) int64, and their block quads in slot
        order, (k * total_blocks_per_slot, 32, 128) int32."""
        slots = np.array([i for i, _ in self._staged], np.int64)
        quads = blocks_from_tile_packed if self.block_packed else blocks_from_tile
        words = np.stack(
            [quads(mips, self.patch_plan) for _, mips in self._staged]
        ).reshape(-1, 32, 128).astype(np.int32)
        return slots, words

    def flush_uploads(self) -> int:
        """Copy the staged tiles into the device slabs and block array: per
        mip, and for the block quads, one host-to-device copy and one
        ``index_copy_`` per frame (the replacement for per-tile
        ``write_texture`` uploads, gpu_tile_atlas.rs:309-336). Call from the
        thread that owns the device stream."""
        if not self._staged:
            return 0
        self.upload_slabs(self._staged)
        if self.block_array is not None:
            slots, words = self._staged_quads()
            per_slot = self.patch_plan.total_blocks_per_slot
            block_idx = (slots[:, None] * per_slot + np.arange(per_slot)[None, :]).reshape(-1)
            tracing.count("upload_bytes", block_idx.nbytes + words.nbytes)
            self.block_array.index_copy_(
                0,
                torch.from_numpy(block_idx).to(self.device),
                torch.from_numpy(words).to(self.device),
            )
        n = len(self._staged)
        self._staged.clear()
        return n

    def take_block_uploads(self) -> tuple[np.ndarray, np.ndarray]:
        """The frame's staged uploads of the block quads, for a store that
        lives elsewhere (the ranks of parallel/multi_view.py): (slots (k,)
        int64, quads (k * total_blocks_per_slot, 32, 128) int32), see
        :func:`apply_block_uploads`. Empties the staging; writes neither the
        slabs nor this attachment's own block array."""
        if self.block_array is None:
            raise ValueError(f"attachment {self.name!r} has no block store to upload")
        if not self._staged:
            return np.zeros(0, np.int64), np.zeros((0, 32, 128), np.int32)
        out = self._staged_quads()
        self._staged.clear()
        return out

    def write_direct(self, atlas_index: int, mip0: np.ndarray) -> None:
        """Host-side write of a full tile (preprocessing path) + stage upload."""
        mips = attachment_io.generate_mipmaps(mip0, self.config.mip_level_count)
        self.data[atlas_index] = mips[0]
        self._staged.append((atlas_index, mips))

    # -- CPU sampling (reference tile_atlas.rs:249-258) --

    def sample(self, atlas_index: int, atlas_uv: np.ndarray) -> np.ndarray:
        if atlas_index == INVALID_ATLAS_INDEX or self.data[atlas_index] is None:
            return np.zeros(4)
        uv = np.asarray(atlas_uv) * self.config.scale + self.config.offset
        data = self.data[atlas_index]
        from bevy_terrain_tpu_torch import native

        if np.ndim(uv) == 1 and native.available() and data.flags.c_contiguous:
            # C++ single-tap path (terrain_runtime.cpp tr_sample_bilinear):
            # identical math, without the numpy chain's per-call overhead
            # for scalar queries
            return native.sample_bilinear(data, uv, self.config.format.max_value)
        return attachment_io.sample_bilinear_host(
            data, uv, self.config.format.max_value
        )


@dataclasses.dataclass(frozen=True)
class AtlasTileAttachment:
    """(coordinate, atlas slot, attachment) triple (tile_atlas.rs:62-67)."""

    coordinate: TileCoordinate
    atlas_index: int
    attachment_index: int


class TileAtlasState:
    """Residency state machine (reference tile_atlas.rs:282-504).

    Unless ``BT_DISABLE_NATIVE=1`` or ``use_native=False``, every state
    transition is mirrored into the native runtime's C++ machine
    (bevy_terrain_tpu_torch/native) and the per-frame ``get_best_tiles``
    batch walk runs natively (the Python walk remains the oracle —
    equivalence is fuzz-tested in tests/test_torch_native.py).
    """

    def __init__(self, atlas_size: int, attachment_count: int, existing_tiles,
                 use_native: Optional[bool] = None):
        from bevy_terrain_tpu_torch import native as native_mod

        if use_native is None:
            use_native = native_mod.available()
        self._native = (
            native_mod.NativeResidency(atlas_size, attachment_count)
            if use_native
            else None
        )
        if self._native is not None and existing_tiles:
            self._native.add_existing(
                np.array([self._key(t) for t in existing_tiles], np.int64)
            )
        self.tile_states: dict[TileCoordinate, _TileState] = {}
        # FIFO of unused slots == LRU cache (tile_atlas.rs:506-515)
        self.unused_tiles: OrderedDict[int, TileCoordinate] = OrderedDict(
            (i, TileCoordinate.INVALID) for i in range(atlas_size)
        )
        self.existing_tiles: set[TileCoordinate] = set(existing_tiles)
        self.attachment_count = attachment_count
        self.to_load: deque[AtlasTileAttachment] = deque()
        # graceful-exhaustion bookkeeping (see request_tile)
        self._denied: dict = {}
        self.exhausted_requests = 0
        # over-release guard (see release_tile)
        self.release_underflows = 0
        self.to_save: deque[AtlasTileAttachment] = deque()
        self.load_slots = DEFAULT_LOAD_SLOTS
        self.save_slots = DEFAULT_SAVE_SLOTS
        self.max_save_slots = DEFAULT_SAVE_SLOTS
        self.download_slots = DEFAULT_DOWNLOAD_SLOTS
        self.max_download_slots = DEFAULT_DOWNLOAD_SLOTS
        self.max_atlas_write_slots = DEFAULT_ATLAS_WRITE_SLOTS
        # sorted loaded-key snapshot for vectorized get_best_tile
        self._loaded_keys: np.ndarray = np.empty(0, np.int64)
        self._loaded_indices: np.ndarray = np.empty(0, np.int64)
        self._loaded_dirty = True

    @staticmethod
    def _key(coordinate: TileCoordinate) -> int:
        return int(pack_keys(coordinate.side, coordinate.lod, coordinate.x, coordinate.y))

    # -- slot bookkeeping --

    def loaded_tile_attachment(self, tile: AtlasTileAttachment) -> None:
        """One attachment of a tile finished loading (tile_atlas.rs:347-359)."""
        self.load_slots += 1
        state = self.tile_states[tile.coordinate]
        if state.loading_remaining == 0:
            raise RuntimeError(
                "Loaded more attachments than registered with the tile atlas."
            )
        state.loading_remaining -= 1
        if state.loading_remaining == 0:
            self._loaded_dirty = True
        if self._native is not None:
            self._native.loaded(self._key(tile.coordinate))

    def saved_tile_attachment(self) -> None:
        self.save_slots += 1

    def downloaded_tile_attachment(self) -> None:
        self.download_slots += 1

    # -- allocation (reference tile_atlas.rs:369-416) --

    def allocate_tile(self) -> int:
        if not self.unused_tiles:
            raise RuntimeError("Atlas out of indices")  # tile_atlas.rs:384
        atlas_index, old_coordinate = self.unused_tiles.popitem(last=False)
        self.tile_states.pop(old_coordinate, None)
        self._loaded_dirty = True
        return atlas_index

    def get_tile_index(self, coordinate: TileCoordinate) -> int:
        """Atlas index of an existing tile, INVALID otherwise (tile_atlas.rs:369-381)."""
        if coordinate == TileCoordinate.INVALID or coordinate not in self.existing_tiles:
            return INVALID_ATLAS_INDEX
        state = self.tile_states.get(coordinate)
        if state is None:
            raise KeyError(f"tile {coordinate} exists but is not resident")
        return state.atlas_index

    def get_or_allocate_tile(self, coordinate: TileCoordinate) -> int:
        """Preprocessing-path allocation (tile_atlas.rs:391-416): marks the
        tile existing + Loaded immediately."""
        if coordinate == TileCoordinate.INVALID:
            return INVALID_ATLAS_INDEX
        if self._native is not None:
            self._native.get_or_allocate(self._key(coordinate))
        self.existing_tiles.add(coordinate)
        state = self.tile_states.get(coordinate)
        if state is not None:
            return state.atlas_index
        atlas_index = self.allocate_tile()
        self.tile_states[coordinate] = _TileState(
            atlas_index=atlas_index, requests=1, loading_remaining=0
        )
        self._loaded_dirty = True
        return atlas_index

    # -- request / release (reference tile_atlas.rs:418-475) --

    def request_tile(self, coordinate: TileCoordinate) -> None:
        if coordinate not in self.existing_tiles:
            return
        if coordinate not in self.tile_states and not self.unused_tiles:
            # BEYOND the reference: tile_atlas.rs:384 panics "Atlas out of
            # indices" on exhaustion (acknowledged as unacceptable,
            # docs/implementation.md:141-145). Here the request is denied
            # gracefully: the tile stays unloaded, geometry keeps serving
            # from the best-loaded ancestor (get_best_tiles walk-up), and
            # the denial is counted loudly for capacity alerting.
            self._denied[coordinate] = self._denied.get(coordinate, 0) + 1
            self.exhausted_requests += 1
            return
        if self._native is not None:
            self._native.request(self._key(coordinate))
            self._native.drain_loads()  # Python to_load is authoritative
        state = self.tile_states.get(coordinate)
        if state is not None:
            if state.requests == 0:
                # back from the LRU cache (tile_atlas.rs:426-431)
                self.unused_tiles.pop(state.atlas_index, None)
            state.requests += 1
            return
        atlas_index = self.allocate_tile()
        self.tile_states[coordinate] = _TileState(
            atlas_index=atlas_index,
            requests=1,
            loading_remaining=self.attachment_count,
        )
        for attachment_index in range(self.attachment_count):
            self.to_load.append(
                AtlasTileAttachment(coordinate, atlas_index, attachment_index)
            )

    def retry_denied(self) -> None:
        """Revive requests denied at exhaustion once slots free again
        (see request_tile): the denial converts back into a real request,
        so transient exhaustion does not leave permanently coarse holes."""
        while self.unused_tiles and self._denied:
            coordinate, count = next(iter(self._denied.items()))
            del self._denied[coordinate]
            for _ in range(count):
                self.request_tile(coordinate)

    def release_tile(self, coordinate: TileCoordinate) -> None:
        if coordinate not in self.existing_tiles:
            return
        denied = self._denied.get(coordinate, 0)
        if denied:  # matches a request denied at exhaustion (never counted)
            if denied == 1:
                del self._denied[coordinate]
            else:
                self._denied[coordinate] = denied - 1
            return
        if self._native is not None:
            self._native.release(self._key(coordinate))
        state = self.tile_states.get(coordinate)
        if state is None:
            raise RuntimeError("Tried releasing a tile, which is not present.")
        if state.requests == 0:
            # Over-release of a cached (requests == 0, LRU-resident) tile:
            # the reference underflows its u32 refcount here in release
            # builds (tile_atlas.rs:459-475). Guard + loud counter instead,
            # mirroring the graceful-exhaustion precedent above. The
            # native backend applies the identical guard (fuzz parity).
            self.release_underflows += 1
            return
        state.requests -= 1
        if state.requests == 0:
            self.unused_tiles[state.atlas_index] = coordinate  # LRU push_back

    # -- vectorized best-loaded-ancestor (reference tile_atlas.rs:477-503) --

    def _refresh_loaded(self) -> None:
        if not self._loaded_dirty:
            return
        keys, idxs = [], []
        for coord, state in self.tile_states.items():
            if state.loading_remaining == 0 and coord.lod <= 26:
                keys.append(pack_keys(coord.side, coord.lod, coord.x, coord.y))
                idxs.append(state.atlas_index)
        order = np.argsort(np.asarray(keys, np.int64)) if keys else []
        self._loaded_keys = np.asarray(keys, np.int64)[order] if keys else np.empty(0, np.int64)
        self._loaded_indices = np.asarray(idxs, np.int64)[order] if keys else np.empty(0, np.int64)
        self._loaded_dirty = False

    def get_best_tiles(self, side, lod, x, y) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized parent walk: for each (side, lod, x, y) find the
        deepest loaded ancestor. Returns (atlas_index, atlas_lod) int32
        arrays (INVALID where nothing is loaded)."""
        if self._native is not None:
            shape = np.asarray(side).shape
            idx, lod_out = self._native.best_tiles(side, lod, x, y)
            return idx.reshape(shape), lod_out.reshape(shape)
        self._refresh_loaded()
        side = np.asarray(side, np.int64)
        lod = np.asarray(lod, np.int64)
        x = np.asarray(x, np.int64)
        y = np.asarray(y, np.int64)
        best_index = np.full(side.shape, INVALID_ATLAS_INDEX, np.int32)
        best_lod = np.full(side.shape, INVALID_LOD, np.int32)
        if self._loaded_keys.size == 0:
            return best_index, best_lod
        max_lod = int(lod.max(initial=0))
        for ancestor in range(max_lod, -1, -1):
            shift = lod - ancestor
            consider = (shift >= 0) & (best_index == INVALID_ATLAS_INDEX)
            if not consider.any():
                continue
            sh = np.maximum(shift, 0)
            keys = pack_keys(side, ancestor, x >> sh, y >> sh)
            pos = np.searchsorted(self._loaded_keys, keys)
            pos = np.clip(pos, 0, self._loaded_keys.size - 1)
            hit = consider & (self._loaded_keys[pos] == keys)
            best_index = np.where(hit, self._loaded_indices[pos].astype(np.int32), best_index)
            best_lod = np.where(hit, np.int32(ancestor), best_lod)
        return best_index, best_lod


class TileAtlas:
    """Per-terrain sparse attachment store (reference tile_atlas.rs:519-624).

    ``device`` is where the block arrays live (no default: pass
    ``"cuda"`` or ``"cpu"``)."""

    def __init__(self, config: TerrainConfig, device,
                 io_pool: Optional[ThreadPoolExecutor] = None):
        if config.model is None:
            raise ValueError("TerrainConfig.model is required")
        self.model = config.model
        self.path = config.path
        self.atlas_size = config.atlas_size
        self.lod_count = config.lod_count
        self.assets_root = config.assets_root
        self.device = torch.device(device)
        self.attachments = [
            AtlasAttachment(a, config.atlas_size, config.path, self.device,
                            config.assets_root)
            for a in config.attachments
        ]
        existing = self.load_tile_config(config.path, config.assets_root)
        self.state = TileAtlasState(config.atlas_size, len(self.attachments), existing)
        self.io_pool = io_pool or ThreadPoolExecutor(max_workers=8, thread_name_prefix="tile-io")

    # -- per-frame update (reference tile_atlas.rs:574-601 + state.update :327-345) --

    def update(self, released_tiles=(), requested_tiles=()) -> None:
        state = self.state
        # drain queues into IO tasks while slots remain (tile_atlas.rs:327-345)
        while state.save_slots > 0 and state.to_save:
            tile = state.to_save.popleft()
            self.attachments[tile.attachment_index].start_saving(self.io_pool, tile)
            state.save_slots -= 1
        while state.load_slots > 0 and state.to_load:
            tile = state.to_load.popleft()
            self.attachments[tile.attachment_index].start_loading(self.io_pool, tile)
            state.load_slots -= 1
        # poll finished IO
        for attachment in self.attachments:
            attachment.update(state)
        # release before request (reference tile_atlas.rs:590-600)
        for coordinate in released_tiles:
            state.release_tile(coordinate)
        for coordinate in requested_tiles:
            state.request_tile(coordinate)
        state.retry_denied()

    def flush_uploads(self) -> int:
        """Upload every attachment's newly loaded tiles (per frame: the
        tracing counters ``tiles_loaded``, one per attachment of a tile, and
        ``upload_bytes``). Returns the tile attachments uploaded."""
        n = sum(a.flush_uploads() for a in self.attachments)
        tracing.count("tiles_loaded", n)
        return n

    def sample_attachment_host(self, attachment_index, atlas_index, atlas_uv):
        return self.attachments[attachment_index].sample(atlas_index, atlas_uv)

    # -- manifest (reference tile_atlas.rs:605-623) --

    def save_tile_config(self) -> None:
        tc = TC(sorted(self.state.existing_tiles))
        tc.save_file(Path(self.assets_root) / self.path / "config.tc")

    @staticmethod
    def load_tile_config(path: str, assets_root: str = "assets") -> set:
        import sys

        p = Path(assets_root) / path / "config.tc"
        if p.exists():
            return set(TC.load_file(p).tiles)
        # stderr: a caller's stdout may carry a JSON result line
        print("Tile config not found.", file=sys.stderr)
        return set()
