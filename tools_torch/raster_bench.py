"""Rasterizer timing on the bench.py 8k^2 scene.

Twin of tools/raster_bench.py on the port. The frame's mesh comes from the
planar mesh kernel (K1) on the card; the rows (device time per call on the
card, ``utils/timing.device_time_ms``; with ``--cpu``, the least host wall
of a few calls on the CPU):

  raster_only   rasterize_grid at the given resolution (binning + sort +
                scan + resolve) on the frame's mesh
  render_pixel  full render_view: skirts + raster + perspective-correct
                interpolation + per-pixel PBR
  render_debug  a debug view (vertex colors interpolated per pixel)

The raster path is the CAPTURE path (MIGRATING.md capability delta), not
part of the per-vertex frame, so its budget is "fast enough to iterate",
not the 1 ms frame bar.

Usage: python tools_torch/raster_bench.py [--cpu] [--size 1024]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    on_card = device == "cuda"
    size = 1024
    if "--size" in argv:
        size = int(argv[argv.index("--size") + 1])
    # (the JAX tool's jax_compilation_cache_dir and block_format() have no
    # counterpart: the port has one block layout)

    from bevy_terrain_tpu_torch.math import frustum
    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from bevy_terrain_tpu_torch.render.material import StandardMaterial
    from bevy_terrain_tpu_torch.render.raster import rasterize_grid, render_view
    from tools_torch.scenes import TOWARD, build_scene, time_ms

    cfg, plan, blocks, u1, _ = build_scene(device=device)

    def frame(block_array, u):
        # the fused mesh kernel: the path the JAX tool takes on its chip
        # (cfg.pallas_sampling), and the port's on the card
        tiles = refinement.refine_tiles(u, cfg)
        raw, tiles = meshgen.generate_mesh_fused(tiles, block_array, u, cfg, plan, 65535.0)
        return tiles, meshgen.fused_to_grid(raw, tiles, cfg)

    tiles, mesh = frame(blocks, u1)
    n = int(tiles.tile_count)
    print(f"scene: {n} tiles, image {size}x{size}")

    # the exact camera the scene's frustum culling used (scenes.build_scene's
    # u1: toward (1000, -40, 300))
    view = u1.view_world_position.cpu().numpy()
    vp32 = frustum.view_projection(view, view + np.array(TOWARD), np.pi / 3,
                                   16 / 9).astype(np.float32)
    knobs = dict(bin_px=32, bin_cap=512, chunk=16)

    r = rasterize_grid(mesh.positions, mesh.tile_mask, vp32, size, size, **knobs)
    cov = float(r.covered.float().mean())
    print(
        f"coverage {cov:.2f}, bin_overflow {int(r.bin_overflow)}, "
        f"near_culled {int(r.near_culled)}"
    )
    rows = {}
    ms, what = time_ms(
        lambda: rasterize_grid(mesh.positions, mesh.tile_mask, vp32, size, size, **knobs).depth,
        label="raster_only", on_card=on_card,
    )
    rows["raster_only"] = ms
    print(f"raster_only      {ms * 1000:8.1f} us {what}")

    material = StandardMaterial(metallic=0.05, perceptual_roughness=0.9)

    def pixel():
        img, _ = render_view(
            mesh, tiles, u1, cfg, vp32, size, size, material=material,
            shade_mode="pixel", **knobs,
        )
        return img

    ms, what = time_ms(pixel, label="render_pixel", on_card=on_card)
    rows["render_pixel"] = ms
    print(f"render_pixel     {ms * 1000:8.1f} us {what}")

    def dbg():
        img, _ = render_view(
            mesh, tiles, u1, cfg, vp32, size, size,
            debug_view="geometry_lod", **knobs,
        )
        return img

    ms, what = time_ms(dbg, label="render_debug", on_card=on_card)
    rows["render_debug"] = ms
    print(f"render_debug     {ms * 1000:8.1f} us {what}")
    return {"tiles": n, "coverage": cov, "bin_overflow": int(r.bin_overflow),
            "timing": what, "ms": rows}


if __name__ == "__main__":
    main()
