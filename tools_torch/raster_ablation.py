"""Where does rasterize_grid's time go at the bench scene's scale?

Twin of tools/raster_ablation.py on the port. The frame's mesh comes from the
planar mesh kernel (K1) on the bench scene (tools_torch/scenes.build_scene,
the bench camera); then the stages of ``render/raster.py``, each timed
alone on the products of the one before:

  project      vertex projection, culling, per-triangle plane
               coefficients and bin pairs (``_bin_pairs``)
  sort         the (4T,) pairs by two stable sorts (``_sort_pairs_stable``)
  sort_packed  the pairs by one sort of packed 64-bit keys (``_sort_pairs``,
               what rasterize_grid takes)
  table        ranks, the per-level tables from one scatter, gathered onto
               the level-0 bins (``_bin_table``)
  scan         the per-bin candidate scan (``_scan``)
  resolve      winner images and perspective-correct barycentrics
               (``_resolve``)
  full         rasterize_grid end to end

Each row is the device time of one call (``utils/timing.device_time_ms``);
``--cpu`` prints the least host wall of a few calls, named so. The sum of
the stages exceeds ``full`` little: each stage is a call of its own. Also
printed: the candidates the bin caps dropped (``bin_overflow``); a sweep
of ``--bin-cap`` (or of :func:`dropped`, binning alone) finds the cap that
drops none.

Usage: python tools_torch/raster_ablation.py [--cpu] [--size 1024 | WxH]
       [--bin-px 32] [--bin-cap 512] [--chunk 16]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def size_arg(text: str) -> tuple[int, int]:
    """'1024' -> (1024, 1024); '1920x1080' -> (1920, 1080)."""
    w, _, h = text.partition("x")
    return int(w), int(h or w)


def scene_mesh(device, capacity: int = 4096, queue: int = 1024):
    """(mesh, view_proj f32, tile count): the bench frame's mesh from K1
    and the bench camera that culled it."""
    from bevy_terrain_tpu_torch.math import frustum
    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from tools_torch.scenes import TOWARD, build_scene

    cfg, plan, blocks, u1, _ = build_scene(capacity, queue, device=device)
    tiles = refinement.refine_tiles(u1, cfg)
    raw, tiles = meshgen.generate_mesh_fused(tiles, blocks, u1, cfg, plan, 65535.0)
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    view = u1.view_world_position.cpu().numpy()
    vp32 = frustum.view_projection(view, view + np.array(TOWARD), np.pi / 3,
                                   16 / 9).astype(np.float32)
    return mesh, vp32, int(tiles.tile_count)


def dropped(mesh, vp32, width: int, height: int, bin_px: int = 32, bin_cap: int = 512,
            chunk: int = 16) -> int:
    """The candidates the bin caps drop at these knobs (binning alone, no
    scan): ``bin_overflow``."""
    from bevy_terrain_tpu_torch.render import raster as R

    vp = R._f32_on(vp32, mesh.positions.device)
    return int(R._bin(mesh.positions, mesh.tile_mask, vp, width, height, bin_px, bin_cap, chunk,
                      False, 1e-4).bin_overflow)


def stages(mesh, vp32, width: int, height: int, bin_px: int = 32, bin_cap: int = 512,
           chunk: int = 16, on_card: bool = True) -> dict:
    """Time each stage alone at these knobs; print the rows. Returns
    {"timing", "ms": {stage: ms}, "dropped", "coverage", "triangles",
    "bins", "caps"}."""
    from bevy_terrain_tpu_torch.render import raster as R
    from tools_torch.scenes import time_ms

    positions, tile_mask = mesh.positions, mesh.tile_mask
    vp = R._f32_on(vp32, positions.device)
    pair_args = (positions, tile_mask, vp, width, height, bin_px, bin_cap, False, 1e-4)
    p = R._bin_pairs(*pair_args)
    T = p.tri_vidx.shape[0]
    g = p.grid
    print(f"scene: T={T} tris, NB={g.nbx * g.nby} bins x {bin_px}px, levels={g.levels}, "
          f"caps={g.caps} (total {sum(g.caps)}), chunk={chunk}, image {width}x{height}")
    s_key, s_tri = R._sort_pairs(p.key, p.znear_key, T, p.nkeys)
    b = R._bin_table(p, s_key, s_tri, chunk)
    best_z, best_t = R._scan(b, bin_px, chunk)
    calls = {
        "project": lambda: R._bin_pairs(*pair_args).key,
        "sort": lambda: R._sort_pairs_stable(p.key, p.znear_key, T)[0],
        "sort_packed": lambda: R._sort_pairs(p.key, p.znear_key, T, p.nkeys)[0],
        "table": lambda: R._bin_table(p, s_key, s_tri, chunk).table,
        "scan": lambda: R._scan(b, bin_px, chunk)[0],
        "resolve": lambda: R._resolve(b, best_z, best_t, width, height, bin_px).depth,
        "full": lambda: R.rasterize_grid(positions, tile_mask, vp, width, height,
                                         bin_px=bin_px, bin_cap=bin_cap, chunk=chunk).depth,
    }
    rows, what = {}, None
    for name, call in calls.items():
        ms, what = time_ms(call, label=f"raster_{name}", on_card=on_card)
        rows[name] = ms
        print(f"{name:12s} {ms * 1000:10.1f} us {what}")
    full = R.rasterize_grid(positions, tile_mask, vp, width, height, bin_px=bin_px,
                            bin_cap=bin_cap, chunk=chunk)
    drops = int(full.bin_overflow)
    coverage = float(full.covered.float().mean())
    print(f"end-to-end check: coverage {coverage:.3f}, dropped candidates (bin_overflow) "
          f"{drops} at bin_cap {bin_cap}")
    return {"timing": what, "ms": rows, "dropped": drops, "coverage": coverage,
            "triangles": T, "bins": g.nbx * g.nby, "caps": list(g.caps)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--size", type=size_arg, default=(1024, 1024),
                    help="image size: N (square) or WxH")
    ap.add_argument("--bin-px", type=int, default=32)
    ap.add_argument("--bin-cap", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=4096)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    # (the JAX tool's jax_compilation_cache_dir and block_format() have no
    # counterpart: the port has one block layout)
    mesh, vp32, n = scene_mesh(device, args.capacity)
    print(f"scene: {n} tiles")
    return stages(mesh, vp32, *args.size, args.bin_px, args.bin_cap, args.chunk,
                  on_card=not args.cpu)


if __name__ == "__main__":
    main()
