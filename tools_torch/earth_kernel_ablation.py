"""Attribute the Earth fused-kernel time by static ablation.

Twin of tools/earth_kernel_ablation.py on the port. Builds the Earth frame
of tools_torch/earth_frame_bench.py (a 6.371e6 m cube sphere, 13 geometry
lods over 3 data lods, a 512-slot atlas, capacity and queue 2048, a
60-degree culled camera at 60 km, the Taylor high-precision path), streams
it until settled, then times ``meshgen.generate_mesh_fused`` on the settled
frame's inputs with named pieces of the spherical kernel (K2) removed
(ops/kernels.py ``ablate``, csrc/mesh_fused.cu):

  full        the production spherical kernel
  no_taylor   both Taylor chains (unmorphed and morphed) removed
  reuse_far   position from the unmorphed geometry (no second far_geom,
              no morphed Taylor chain): the bound of any "evaluate
              far_geom once" scheme
  no_smooth   the 1-2-1 smoothing pass and the second window read removed
  no_phase_a  the resample and its stores removed (quad copies, tents and
              the vertex stage remain)
  reuse+notaylor  both

Each row is the device time of one call (``utils/timing.device_time_ms``:
the CUDA kernels of refinement, patch plan and mesh kernel per call), then
the deltas against ``full``. ``--cpu`` runs on the CPU with the plain
versions and prints their host wall, named so (not a device time).

Usage: python tools_torch/earth_kernel_ablation.py [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = [
    ("full", frozenset()),
    ("no_taylor", frozenset({"no_taylor"})),
    ("reuse_far", frozenset({"reuse_far"})),
    ("no_smooth", frozenset({"no_smooth"})),
    ("no_phase_a", frozenset({"no_phase_a"})),
    ("reuse+notaylor", frozenset({"reuse_far", "no_taylor"})),
]


def frame(device, capacity: int = 2048, queue: int = 2048, altitude_km: float = 60.0):
    """The settled Earth frame's inputs as the pipeline's step sees them:
    (tiles, block_array, uniforms, cfg, plan, max_value)."""
    import torch

    from bevy_terrain_tpu_torch.math.frustum import view_projection
    from bevy_terrain_tpu_torch.ops import refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from tools_torch.earth_frame_bench import RADIUS, earth_terrain, settle

    terrain = earth_terrain(device, capacity, queue)
    view = np.array([0.0, 0.0, RADIUS + altitude_km * 1e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    settle(terrain, view, vp)
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]
    blob = torch.from_numpy(terrain.last_uniform_blob("cam")).to(device)
    u = unpack_frame_uniforms(blob, cfg.side_count, cfg.lod_count, cfg.tree_size)
    tiles = refinement.refine_tiles(u, cfg)
    return (tiles, height.block_array, u, cfg, height.patch_plan,
            height.config.format.max_value)


def run_variants(inputs, on_card: bool, variants=VARIANTS) -> dict:
    """Time ``generate_mesh_fused`` per variant on ``inputs`` (:func:`frame`);
    prints each row and the deltas against the first. Returns {name: ms},
    with "timing" naming what was timed and "tiles" the frame's count."""
    from bevy_terrain_tpu_torch.ops import meshgen
    from tools_torch.scenes import time_ms

    tiles, blocks, u, cfg, plan, max_value = inputs
    rows: dict = {}
    what = None
    for name, abl in variants:
        def step(abl=abl):
            return meshgen.generate_mesh_fused(tiles, blocks, u, cfg, plan, max_value,
                                               ablate=abl)[0]

        ms, what = time_ms(step, label=f"abl_{name}", on_card=on_card)
        rows[name] = ms
        print(f"{name:16s} {ms * 1e3:10.1f} us {what}  (tiles {int(tiles.tile_count)})",
              flush=True)
    full = rows[variants[0][0]]
    print(f"\nattribution (deltas vs {variants[0][0]}, {what}):")
    for name, _ in variants[1:]:
        print(f"  {name:16s} -{(full - rows[name]) * 1e3:9.1f} us")
    return {"timing": what, "tiles": int(tiles.tile_count), "ms": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--queue", type=int, default=2048)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    # (the JAX tool's jax_compilation_cache_dir has no counterpart here)
    return run_variants(frame(device, args.capacity, args.queue), not args.cpu)


if __name__ == "__main__":
    main()
