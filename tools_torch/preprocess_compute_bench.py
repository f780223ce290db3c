"""Preprocess COMPUTE throughput: device stack ops against host numpy.

Twin of tools/preprocess_compute_bench.py on the port: the split /
downsample / stitch / mip math alone, without file IO or the read-back.
The workload: 512^2 R16 tiles at 4 lods, 64 finest tiles, a 2048^2
source; the device side splits the source into 8 tile-row bands by tent
matrices (``ops/preprocess._tent_matrix``, ``_resize_rows``,
``_resize_cols``: full f32, TF32 off for the call), then downsamples,
stitches every lod and makes the finest lod's mips as whole stacks
(``ops/preprocess_device.py``); the host side runs the numpy path of
``ops/preprocess.py`` tile by tile. Prints tiles/s for each and their
ratio; the card's side is host wall with a sync (kernel launches
included). --cpu runs the stack ops on the CPU, named so.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TS, B = 512, 2  # texture and border size
LODS = 4
SOURCE = 2048  # source side, texels


def workload():
    """(finest, source): the finest lod's tiles, (n, TS, TS, 1) f32 in [1,
    65535), and the (SOURCE, SOURCE, 1) f32 source, ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    count = 1 << (LODS - 1)
    finest = rng.uniform(1, 65535, (count * count, TS, TS, 1)).astype(np.float32)
    source = rng.uniform(0.01, 1.0, (SOURCE, SOURCE, 1)).astype(np.float32)
    return finest, source


def device_compute(finest: torch.Tensor, source: torch.Tensor) -> int:
    """The stack ops on the tensors' device; returns the tiles made."""
    from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
    from bevy_terrain_tpu_torch.ops import preprocess_device as ppd
    from bevy_terrain_tpu_torch.ops.preprocess import _resize_cols, _resize_rows, _tent_matrix

    dev = source.device
    cs = TS - 2 * B
    finest_lod = LODS - 1
    count = 1 << finest_lod
    H, W = source.shape[:2]
    # split: one band of tile rows at a time at the finest lod
    P = count * cs
    uv = (np.arange(P) + 0.5) / P
    px = uv * W - 0.5
    py = uv * H - 0.5
    mx = torch.from_numpy(_tent_matrix(px, W)).to(dev)
    bands = []
    for ty in range(count):
        my = torch.from_numpy(_tent_matrix(py[ty * cs:(ty + 1) * cs], H)).to(dev)
        bands.append(_resize_cols(_resize_rows(my, source), mx))
    torch.stack(bands)  # the split stack, (count, cs, P, 1)
    # downsample chain over the finest stack
    coords = [TileCoordinate(0, finest_lod, x, y) for x in range(count) for y in range(count)]
    stacks = {finest_lod: finest}
    for lod in reversed(range(finest_lod)):
        parents = [TileCoordinate(0, lod, x, y) for x in range(1 << lod) for y in range(1 << lod)]
        child_index = {c: i for i, c in enumerate(coords)}
        idx = np.array([[child_index.get(ch, -1) for ch in c.children()] for c in parents],
                       np.int32)
        stacks[lod] = ppd.downsample_stack(stacks[lod + 1], idx, TS, B)
        coords = parents
    # stitch every lod, mips for the finest
    total = 0
    for lod, stack in stacks.items():
        cl = [TileCoordinate(0, lod, x, y) for x in range(1 << lod) for y in range(1 << lod)]
        nbr_idx, nbr_side = ppd.stitch_plan(cl, {c: i for i, c in enumerate(cl)}, False)
        stitched = ppd.stitch_stack(stack, np.zeros(len(cl), np.int64), nbr_idx, nbr_side, B,
                                    False)
        total += stitched.shape[0]
    ppd.mip_stack(stacks[finest_lod], 4, True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return total + count * count


def host_compute(source: np.ndarray) -> int:
    """The numpy host path tile by tile; returns the tiles made."""
    from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
    from bevy_terrain_tpu_torch.ops import preprocess as pph
    from bevy_terrain_tpu_torch.terrain_data.attachment import generate_mipmaps

    cs = TS - 2 * B
    finest_lod = LODS - 1
    count = 1 << finest_lod
    mosaic, valid = pph.split_mosaic(source, finest_lod, cs, (0, 0), (1, 1))
    tiles = {}
    for x in range(count):
        for y in range(count):
            tiles[(finest_lod, x, y)] = pph.extract_tile_from_mosaic(
                mosaic, valid, x, y, TS, B, np.uint16, 65535.0)
    for lod in reversed(range(finest_lod)):
        for x in range(1 << lod):
            for y in range(1 << lod):
                kids = [tiles.get((lod + 1, 2 * x + dx, 2 * y + dy))
                        for dy in (0, 1) for dx in (0, 1)]
                tiles[(lod, x, y)] = pph.downsample_tile(kids, TS, B)
    n = 0
    for (lod, x, y), t in list(tiles.items()):
        neighbours = []
        for nb in TileCoordinate(0, lod, x, y).neighbours(False):
            neighbours.append((0, tiles.get((nb.lod, nb.x, nb.y))) if nb.is_valid
                              else (0, None))
        pph.stitch_tile(t, 0, neighbours, B)
        n += 1
    for x in range(count):
        for y in range(count):
            generate_mipmaps(tiles[(finest_lod, x, y)].astype(np.uint16), 4)
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    finest, source = workload()
    finest_d = torch.from_numpy(finest).to(device)
    source_d = torch.from_numpy(source).to(device)
    device_compute(finest_d, source_d)  # warm: allocator, first launches
    t0 = time.perf_counter()
    n_dev = device_compute(finest_d, source_d)
    dt_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_host = host_compute(source)
    dt_host = time.perf_counter() - t0
    what = "CPU torch ops" if args.cpu else f"device ({torch.cuda.get_device_name(0)})"
    print(f"{what} compute: {n_dev} tiles in {dt_dev:.3f}s = {n_dev / dt_dev:.1f} tiles/s")
    print(f"host compute:   {n_host} tiles in {dt_host:.3f}s = {n_host / dt_host:.1f} tiles/s")
    ratio = dt_host / dt_dev * (n_dev / n_host)
    print(f"ratio: {ratio:.1f}x")
    return {"timing": what, "device_tiles": n_dev, "device_s": dt_dev,
            "device_tiles_per_s": n_dev / dt_dev, "host_tiles": n_host, "host_s": dt_host,
            "host_tiles_per_s": n_host / dt_host, "ratio": ratio}


if __name__ == "__main__":
    main()
