"""Offline dataset preprocessing: source imagery -> streamed tile store.

Torch twin of the JAX package's ``preprocess/preprocessor.py`` (behavioral
twin of the reference's preprocess task graph, preprocessor.rs): per
dataset, SPLIT all tiles of the finest lod from the source image, then
DOWNSAMPLE coarser lods (children -> parent), then per lod STITCH borders
from the 8 neighbours and SAVE to disk; the spherical variant runs per cube
face with cross-face stitching (preprocessor.rs:234-343). Barriers separate
the phases.

Tasks are processed in whole-lod batches. Three paths write the same
artifacts:

* the host path: numpy per tile (ops/preprocess.py);
* the device path, ``readback="full"``: split, downsample and stitch as
  torch ops over whole-lod stacks on the atlas's device
  (ops/preprocess_device.py), the stacks held there at the format's stored
  width until their lod is stitched and read back whole;
* the device path, ``readback="delta"``: the host split and downsample, the
  stitch on the device, and only the border strips read back.

The device's working set is bounded: downsample and stitch run over a lod
in chunks of at most ``batch_tiles`` tiles and ``_CHUNK_BYTES`` of f32
tiles, and the full read-back checks its planned peak against the device's
free memory before it splits a dataset.

Results enter the atlas's normal save path (bounded save slots, async
writes, tile_atlas.rs:318-345 semantics).
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
from bevy_terrain_tpu_torch.ops import preprocess_device as ppd
from bevy_terrain_tpu_torch.ops.preprocess import (
    _tap_weights,
    downsample_tile,
    extract_tile_from_mosaic,
    split_mosaic,
    stitch_tile,
)
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import AtlasTileAttachment, TileAtlas

# Downsample and stitch work through a lod's stack in chunks of at most this
# many bytes of f32 tiles (at least one tile), so beside the job's stacks at
# their stored width the device holds a bounded working set.
_CHUNK_BYTES = 64 << 20
# f32 copies of a chunk that downsample_stack / stitch_stack hold at once
# (gathered children, their quadrants and masks, the sums; the stitched
# clone), and of a row band of the split
_CHUNK_COPIES, _BAND_COPIES = 8, 6
# f32 copies of a stitch chunk's halo (the gathered neighbours outside the
# chunk, and their conversion from the stored width); a chunk of k tiles in
# column order has at most 2k + 6 of them
_HALO_COPIES = 2


def _free_device_bytes(device) -> Optional[int]:
    """Bytes new tensors on ``device`` can take: the driver's free memory
    and what torch's caching allocator holds unused. None on the CPU."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def reset_directory(directory) -> None:
    """Clear an attachment's data directory + the config.tc manifest
    (reference preprocessor.rs:18-22)."""
    directory = Path(directory)
    tc = directory.parent.parent / "config.tc"
    tc.unlink(missing_ok=True)
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True, exist_ok=True)


@dataclasses.dataclass
class PreprocessDataset:
    """One planar source image covering a uv region of one cube side
    (reference preprocessor.rs:35-55)."""

    attachment_index: int = 0
    path: str = ""
    side: int = 0
    top_left: tuple[float, float] = (0.0, 0.0)
    bottom_right: tuple[float, float] = (1.0, 1.0)
    lod_range: range = dataclasses.field(default_factory=lambda: range(0, 1))

    def overlapping_tiles(self, lod: int):
        """Tiles of a lod intersecting the dataset region
        (reference preprocessor.rs:58-67)."""
        count = TileCoordinate.count(lod)
        lx = int(self.top_left[0] * count)
        ly = int(self.top_left[1] * count)
        ux = int(np.ceil(self.bottom_right[0] * count))
        uy = int(np.ceil(self.bottom_right[1] * count))
        for x in range(lx, ux):
            for y in range(ly, uy):
                yield TileCoordinate(self.side, lod, x, y)


@dataclasses.dataclass
class SphericalDataset:
    """Six per-face source images (reference preprocessor.rs:29-33)."""

    attachment_index: int
    paths: list[str]
    lod_range: range


class Preprocessor:
    """Builds and runs the preprocess task graph for one terrain
    (reference preprocessor.rs:213-343 + select_ready_tasks :346-399).

    Usage mirrors the reference examples (examples/preprocess_planar.rs)::

        Preprocessor(TileAtlas(config, "cuda")).clear_attachment(0) \\
            .preprocess_tile(dataset).run()
    """

    def __init__(self, tile_atlas: TileAtlas, loader=None,
                 device: Optional[bool] = None, batch_tiles: int = 256,
                 naive: bool = False, readback: Optional[str] = None):
        """``device=True`` runs split/downsample/stitch as torch ops over
        whole-lod stacks on ``tile_atlas.device``
        (ops/preprocess_device.py); ``device=False`` keeps the per-tile host
        numpy oracles. Default (None) decides by the atlas's device type: the
        device path on a CUDA atlas, the host path on a CPU atlas (there the
        stack ops ARE host compute; ``device=True`` on a CPU atlas is for
        parity tests).

        ``loader(path, attachment_config)`` returns the source as (H, W, C)
        float32 in [0, 1], 0 = nodata; the default reads an image file with
        PIL (formats/tiff.py).

        ``batch_tiles`` bounds the device stacks at deep lods: downsample and
        stitch work through a lod in chunks of at most this many tiles, and
        of at most ``_CHUNK_BYTES`` of f32 tiles, whichever is fewer. The
        bytes written do not depend on it.

        ``naive=True`` pins the single-thread numpy CPU-reference oracle's
        split (dense tent matmuls; every host downsample here is numpy, the
        JAX package's oracle). Output stays byte-identical to the host path.

        ``readback`` (device path only) selects how stitched tiles return
        to the host: ``"full"`` (the default) reads whole stitched stacks
        back; ``"delta"`` keeps split/downsample interiors host-side
        (bit-identical to the device ops) and reads back ONLY the stitched
        border strips (~1.5% of the bytes — stitch never writes interiors,
        stitch.wgsl:58-67). The full read-back holds every lod of a dataset
        on the device (a cube's six sides together) and raises MemoryError
        before the split when that would not fit; ``"delta"`` holds one
        chunk of one lod at a time."""
        if batch_tiles < 1:
            raise ValueError(f"batch_tiles must be at least 1, got {batch_tiles}")
        if naive:
            device = False
        if device is None:
            device = tile_atlas.device.type == "cuda"
        self.readback = readback or "full"
        self.atlas = tile_atlas
        self.loader = loader or _default_loader
        self.device = device
        self.batch_tiles = batch_tiles
        self.naive = naive
        self._jobs: list = []
        self._dev_stacks: dict = {}
        self.start_time: Optional[float] = None

    # -- graph construction --

    def clear_attachment(self, attachment_index: int) -> "Preprocessor":
        """Reference preprocessor.rs:290-296."""
        attachment = self.atlas.attachments[attachment_index]
        self.atlas.state.existing_tiles.clear()
        reset_directory(attachment.path)
        return self

    def preprocess_tile(self, dataset: PreprocessDataset) -> "Preprocessor":
        """Queue split+downsample then per-lod stitch+save
        (reference preprocessor.rs:298-312)."""
        self._jobs.append(("planar", dataset))
        return self

    def preprocess_spherical(self, dataset: SphericalDataset) -> "Preprocessor":
        """Reference preprocessor.rs:314-343: six per-side datasets, split+
        downsample all sides first, then stitch+save lod by lod (cross-face
        borders need all sides split)."""
        self._jobs.append(("spherical", dataset))
        return self

    # -- execution --

    def run(self, verbose: bool = True) -> None:
        self.start_time = time.time()
        for kind, dataset in self._jobs:
            if kind == "planar":
                self._split_and_downsample(dataset)
                for lod in dataset.lod_range:
                    self._stitch_and_save_layer(dataset, lod)
                    self._drop_lod(dataset.attachment_index, lod)
            else:
                sides = [
                    PreprocessDataset(
                        attachment_index=dataset.attachment_index,
                        path=dataset.paths[side],
                        side=side,
                        lod_range=dataset.lod_range,
                    )
                    for side in range(6)
                ]
                for side_dataset in sides:
                    self._split_and_downsample(side_dataset)
                for lod in dataset.lod_range:
                    for side_dataset in sides:
                        self._stitch_and_save_layer(side_dataset, lod)
                    self._drop_lod(dataset.attachment_index, lod)
        self._drain_saves()
        self.atlas.save_tile_config()
        if verbose:
            print(
                f"Preprocessing took {time.time() - self.start_time:.2f}s",
                file=sys.stderr,
            )
        self._jobs.clear()

    # -- phases (reference preprocessor.rs:234-288) --

    def _attachment(self, dataset):
        return self.atlas.attachments[dataset.attachment_index]

    def _data(self, attachment, coordinate) -> Optional[np.ndarray]:
        index = self.atlas.state.tile_states.get(coordinate)
        return attachment.data[index.atlas_index] if index is not None else None

    def _split_and_downsample(self, dataset: PreprocessDataset) -> None:
        lods = list(dataset.lod_range)[::-1]
        if self.device and self.readback == "full":
            key = (dataset.attachment_index, dataset.side)
            self._dev_stacks[key + (lods[0],)] = self._split_device(dataset)
            for lod in lods[1:]:
                self._dev_stacks[key + (lod,)] = self._downsample_device(
                    dataset, lod, *self._dev_stacks[key + (lod + 1,)])
            return
        # device "delta" mode intentionally runs the HOST split/downsample
        # (bit-identical to the device stack ops) so interiors never need
        # to be read back
        self._split_host(dataset)
        for lod in lods[1:]:
            self._downsample_host(dataset, lod)

    def _split_host(self, dataset: PreprocessDataset) -> None:
        attachment = self._attachment(dataset)
        cfg = attachment.config
        source = self.loader(dataset.path, cfg)
        finest = max(dataset.lod_range)
        mosaic, valid = split_mosaic(
            source, finest, cfg.center_size, dataset.top_left,
            dataset.bottom_right, naive=self.naive,
        )
        for c in dataset.overlapping_tiles(finest):
            atlas_index = self.atlas.state.get_or_allocate_tile(c)
            existing = attachment.data[atlas_index]
            attachment.data[atlas_index] = extract_tile_from_mosaic(
                mosaic, valid, c.x, c.y, cfg.texture_size, cfg.border_size,
                cfg.format.dtype, cfg.format.max_value, existing,
            )

    def _downsample_host(self, dataset: PreprocessDataset, lod: int) -> None:
        attachment = self._attachment(dataset)
        cfg = attachment.config
        for c in dataset.overlapping_tiles(lod):
            children = [self._data(attachment, child) for child in c.children()]
            atlas_index = self.atlas.state.get_or_allocate_tile(c)
            attachment.data[atlas_index] = downsample_tile(
                children, cfg.texture_size, cfg.border_size
            )

    # -- device phases (torch stack ops, ops/preprocess_device.py) --

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array (a source, prior tiles) as an f32 tensor on the
        atlas's device, without a stream sync."""
        return ppd.to_device(np.asarray(array, np.float32), self.atlas.device)

    def _read_back(self, stack: torch.Tensor, dtype) -> np.ndarray:
        """A stack at the stored width of ``dtype`` read back (the one sync
        of its lod stack)."""
        return ppd.read_stored(stack, dtype)

    def _drop_lod(self, attachment_index: int, lod: int) -> None:
        """Free a stitched lod's device stacks (every side's)."""
        for key in [k for k in self._dev_stacks if k[0] == attachment_index and k[2] == lod]:
            del self._dev_stacks[key]

    def _chunk_tiles(self, cfg) -> int:
        """Tiles in one downsample or stitch chunk: at most ``batch_tiles``
        and ``_CHUNK_BYTES`` of f32 tiles, and at least one."""
        tile_bytes = cfg.texture_size ** 2 * cfg.format.channels * 4
        return max(1, min(self.batch_tiles, _CHUNK_BYTES // tile_bytes))

    def planned_device_bytes(self, dataset: PreprocessDataset, source_shape) -> int:
        """About the most device memory the full read-back adds while it
        preprocesses ``dataset`` from a source of ``source_shape`` (H, W, C):
        its lod stacks at the stored width, the finest lod's stitched copy,
        the f32 source with its validity masks, and the f32 working set of
        a chunk (with a stitch chunk's halo of neighbours) and of a row
        band."""
        cfg = self._attachment(dataset).config
        tile = cfg.texture_size ** 2 * cfg.format.channels
        item = cfg.format.dtype.itemsize
        counts = [len(list(dataset.overlapping_tiles(lod))) for lod in dataset.lod_range]
        H, W, C = source_shape
        P = (1 << max(dataset.lod_range)) * cfg.center_size
        band = cfg.center_size * max(W, P) * C * 4
        chunk = min(self._chunk_tiles(cfg), max(counts))
        return ((sum(counts) + max(counts)) * tile * item + H * W * (C * 4 + 1) + H * P
                + (_CHUNK_COPIES * chunk + _HALO_COPIES * (2 * chunk + 6)) * tile * 4
                + _BAND_COPIES * band)

    def _split_device(self, dataset: PreprocessDataset):
        """Split the finest lod on the device: per row band of tiles, the
        2-tap bilinear of the source, quantized, cut into tiles, borders
        zero, composited with any prior tile under ``valid``
        (split.wgsl:19-42). Returns (coords, (N, ts, ts, C) stack at the
        stored width).

        Mirrors the reference's GPU compute passes (preprocess/mod.rs:143-218)
        with whole-lod batches instead of 32-write-slot chunks."""
        attachment = self._attachment(dataset)
        cfg = attachment.config
        source = self.loader(dataset.path, cfg)
        need = self.planned_device_bytes(dataset, source.shape)
        free = _free_device_bytes(self.atlas.device)
        if free is not None and need > free:
            raise MemoryError(
                f"preprocessing {dataset.path!r} (side {dataset.side}, lods "
                f"{min(dataset.lod_range)}-{max(dataset.lod_range)}) with the full "
                f"read-back takes about {need / 1e9:.2f} GB of {self.atlas.device}; "
                f"{free / 1e9:.2f} GB are free. Use readback='delta' (one chunk of one "
                "lod on the device at a time) or device=False.")
        H, W, C = source.shape
        ts, b, center = cfg.texture_size, cfg.border_size, cfg.center_size
        max_value, fmt = cfg.format.max_value, cfg.format.dtype
        finest = max(dataset.lod_range)
        count = 1 << finest
        P = count * center

        # source positions of mosaic texels (split.wgsl:28-33 inverse_mix)
        uv = (np.arange(P, dtype=np.float64) + 0.5) / P
        tlx, tly = dataset.top_left
        brx, bry = dataset.bottom_right
        px = ((uv - tlx) / (brx - tlx)) * W - 0.5
        py = ((uv - tly) / (bry - tly)) * H - 0.5
        src = self._upload(source)
        dev = src.device

        def taps(p, size):
            return [ppd.to_device(a, dev) for a in _tap_weights(p, size)]

        x_taps, y_taps = taps(px, W), taps(py, H)
        # validity: the reference's 4-tap textureGather nodata test on
        # channel 0 (split.wgsl:34); a nodata-free source skips it
        all_valid = bool((source[..., 0] != 0).all())
        if not all_valid:
            x0 = np.clip(np.floor(px).astype(np.int64), 0, W - 1)
            x1 = np.clip(x0 + 1, 0, W - 1)
            y0 = np.clip(np.floor(py).astype(np.int64), 0, H - 1)
            y1 = np.clip(y0 + 1, 0, H - 1)
            nz = src[..., 0] != 0
            gate = nz[:, ppd.to_device(x0, dev)] & nz[:, ppd.to_device(x1, dev)]
            vy0, vy1 = ppd.to_device(y0, dev), ppd.to_device(y1, dev)

        coords = list(dataset.overlapping_tiles(finest))
        stack = torch.zeros((len(coords), ts, ts, C), dtype=ppd.stored_dtype(fmt), device=dev)
        for i, c in enumerate(coords):
            prior = self._data(attachment, c)
            if prior is not None:
                stack[i] = ppd.to_stored(self._upload(prior), fmt)
        inner = stack[:, b:b + center, b:b + center]
        for ty in sorted({c.y for c in coords}):
            rows = slice(ty * center, (ty + 1) * center)
            band = ppd.split_bilinear(src, x_taps, [t[rows] for t in y_taps])
            quant = torch.clamp(torch.round(band * max_value), 0, max_value)
            tiles = quant.reshape(center, count, center, C).permute(1, 0, 2, 3)
            here = np.array([(i, c.x) for i, c in enumerate(coords) if c.y == ty])
            at, xs = ppd.to_device(here[:, 0], dev), ppd.to_device(here[:, 1], dev)
            new = tiles.index_select(0, xs)
            if not all_valid:
                valid = gate.index_select(0, vy0[rows]) & gate.index_select(0, vy1[rows])
                valid = valid.reshape(center, count, center).permute(1, 0, 2)
                new = torch.where(valid.index_select(0, xs)[..., None], new,
                                  ppd.from_stored(inner.index_select(0, at)))
            inner[at] = ppd.to_stored(new, fmt)
        for c in coords:
            self.atlas.state.get_or_allocate_tile(c)
        return coords, stack

    def _downsample_device(self, dataset: PreprocessDataset, lod: int,
                           child_coords, child_stack):
        """Parents of ``lod`` from the finer lod's device stack, in chunks,
        rounded as the host downsample quantizes. Returns (coords, stack at
        the stored width)."""
        cfg = self._attachment(dataset).config
        child_index = {c: i for i, c in enumerate(child_coords)}
        coords = list(dataset.overlapping_tiles(lod))
        idx = np.full((len(coords), 4), -1, np.int64)
        for i, c in enumerate(coords):
            for q, ch in enumerate(c.children()):
                idx[i, q] = child_index.get(ch, -1)
        dev = child_stack.device
        out = torch.empty((len(coords),) + tuple(child_stack.shape[1:]),
                          dtype=child_stack.dtype, device=dev)
        step = max(1, self._chunk_tiles(cfg) // 4)  # four children a parent
        for s in range(0, len(coords), step):
            block = idx[s:s + step]
            rows = np.unique(block[block >= 0])  # every parent has a child
            children = ppd.from_stored(child_stack.index_select(0, ppd.to_device(rows, dev)))
            local = np.where(block >= 0, np.searchsorted(rows, block), -1)
            parents = ppd.downsample_stack(children, local, cfg.texture_size, cfg.border_size)
            out[s:s + step] = ppd.to_stored(torch.round(parents), cfg.format.dtype)
        for c in coords:
            self.atlas.state.get_or_allocate_tile(c)
        return coords, out

    def _stitch_chunks(self, dataset: PreprocessDataset, coords, handle, gather):
        """Stitch one lod's ``coords`` in chunks of :meth:`_chunk_tiles`
        tiles. ``handle(c)`` names the pre-stitch tile at ``c`` (None
        where there is none); ``gather(handles)`` makes the (n, ts, ts, C)
        f32 device stack of them. Yields (first row, stitched f32 chunk)."""
        cfg = self._attachment(dataset).config
        spherical = self.atlas.model.is_spherical
        step = self._chunk_tiles(cfg)
        for s in range(0, len(coords), step):
            chunk = coords[s:s + step]
            index_of = {c: i for i, c in enumerate(chunk)}
            handles = [handle(c) for c in chunk]
            # neighbours outside the chunk (on a sphere, also on other
            # sides) follow the chunk's rows: stitch_stack reads past Nst
            for c in chunk:
                for n in c.neighbours(spherical):
                    if not n.is_valid or n in index_of:
                        continue
                    h = handle(n)
                    if h is not None:
                        index_of[n] = len(handles)
                        handles.append(h)
            nbr_idx, nbr_side = ppd.stitch_plan(chunk, index_of, spherical)
            yield s, ppd.stitch_stack(
                gather(handles), np.array([c.side for c in chunk]), nbr_idx, nbr_side,
                cfg.border_size, spherical,
            )

    def _stitch_device(self, dataset: PreprocessDataset, lod: int):
        """Stitch a lod's device stack. Returns (coords, stitched stack at
        the stored width) or (None, None) when the dataset has no tile at
        this lod."""
        fmt = self._attachment(dataset).config.format.dtype
        ai = dataset.attachment_index
        coords, stack = self._dev_stacks.get((ai, dataset.side, lod), (None, None))
        if not coords:
            return None, None
        # this lod's stack of every side split so far: cross-face
        # neighbours live in the other sides' stacks
        rows_of = {k[1]: ({c: i for i, c in enumerate(cs)}, st)
                   for k, (cs, st) in self._dev_stacks.items() if k[0] == ai and k[2] == lod}

        def handle(n):
            row = rows_of[n.side][0].get(n) if n.side in rows_of else None
            return None if row is None else (n.side, row)

        def gather(handles):
            out = torch.empty((len(handles),) + tuple(stack.shape[1:]),
                              dtype=torch.float32, device=stack.device)
            for side in sorted({side for side, _ in handles}):
                pos = [i for i, h in enumerate(handles) if h[0] == side]
                rows = ppd.to_device(np.array([handles[i][1] for i in pos]), stack.device)
                out[ppd.to_device(np.array(pos), stack.device)] = ppd.from_stored(
                    rows_of[side][1].index_select(0, rows))
            return out

        stitched = torch.empty_like(stack)
        for s, chunk in self._stitch_chunks(dataset, coords, handle, gather):
            stitched[s:s + len(chunk)] = ppd.to_stored(chunk, fmt)
        return coords, stitched

    def _stitch_delta(self, dataset: PreprocessDataset, lod: int):
        """Device stitch of the host tiles: upload each chunk's pre-stitch
        tiles and their neighbours, stitch on the device, and keep ONLY the
        border strips. Returns (coords, (N, K) strips at the stored width)
        or (None, None)."""
        attachment = self._attachment(dataset)
        cfg = attachment.config
        coords = [
            c for c in dataset.overlapping_tiles(lod)
            if self._data(attachment, c) is not None
        ]
        if not coords:
            return None, None
        own, existing = set(coords), self.atlas.state.existing_tiles

        def handle(n):
            return self._data(attachment, n) if n in own or n in existing else None

        K = ppd.border_strip_length(cfg.texture_size, cfg.border_size, cfg.format.channels)
        strips = torch.empty((len(coords), K), dtype=ppd.stored_dtype(cfg.format.dtype),
                             device=self.atlas.device)
        for s, chunk in self._stitch_chunks(dataset, coords, handle,
                                            lambda tiles: self._upload(np.stack(tiles))):
            strips[s:s + len(chunk)] = ppd.to_stored(
                ppd.extract_borders(chunk, cfg.border_size), cfg.format.dtype)
        return coords, strips

    def _stitch_host(self, dataset: PreprocessDataset, lod: int):
        """Per-tile host stitch of a lod. Returns (coords, stitched tiles)."""
        attachment = self._attachment(dataset)
        spherical = self.atlas.model.is_spherical
        coords, tiles = [], []
        for c in dataset.overlapping_tiles(lod):
            tile = self._data(attachment, c)
            if tile is None:
                continue
            neighbours = []
            for n in c.neighbours(spherical):
                if not n.is_valid or n not in self.atlas.state.existing_tiles:
                    neighbours.append((0, None))
                else:
                    neighbours.append((n.side, self._data(attachment, n)))
            coords.append(c)
            tiles.append(stitch_tile(tile, c.side, neighbours,
                                     attachment.config.border_size))
        return coords, tiles

    def _stitch_and_save_layer(self, dataset: PreprocessDataset, lod: int) -> None:
        attachment = self._attachment(dataset)
        cfg = attachment.config
        if self.device and self.readback == "delta":
            coords, strips = self._stitch_delta(dataset, lod)
            if not coords:
                return
            host_strips = self._read_back(strips, cfg.format.dtype)  # ~1.5% of bytes
            tiles = []
            for i, c in enumerate(coords):
                tile = self._data(attachment, c).copy()
                ppd.composite_borders(tile, host_strips[i], cfg.border_size)
                tiles.append(tile)
        elif self.device:
            coords, stitched = self._stitch_device(dataset, lod)
            if not coords:
                return
            # the stored width: half the bytes of f32 for R16, a quarter
            # for 8-bit formats
            tiles = self._read_back(stitched, cfg.format.dtype)
        else:
            coords, tiles = self._stitch_host(dataset, lod)
        # write back after the whole layer is stitched (the reference's
        # barrier between stitch and save, preprocessor.rs:282) then save
        for c, tile in zip(coords, tiles):
            state = self.atlas.state.tile_states[c]
            attachment.data[state.atlas_index] = tile
            self.atlas.state.to_save.append(
                AtlasTileAttachment(c, state.atlas_index, dataset.attachment_index)
            )
        self._pump_saves()

    def _pump_saves(self) -> None:
        state = self.atlas.state
        while state.save_slots > 0 and state.to_save:
            tile = state.to_save.popleft()
            self.atlas.attachments[tile.attachment_index].start_saving(
                self.atlas.io_pool, tile
            )
            state.save_slots -= 1

    def _drain_saves(self) -> None:
        while True:
            self._pump_saves()
            pending = any(a.saving for a in self.atlas.attachments)
            for a in self.atlas.attachments:
                a.update(self.atlas.state)
            if not pending and not self.atlas.state.to_save:
                break
            time.sleep(0.005)


def _default_loader(path: str, attachment_config) -> np.ndarray:
    """Load a source image as (H, W, C) float32 in [0, 1] (0 == nodata)."""
    from bevy_terrain_tpu_torch.formats.tiff import load_source_image

    return load_source_image(path, attachment_config)
