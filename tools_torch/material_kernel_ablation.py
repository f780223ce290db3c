"""Attribute the merged mesh + RGBA kernel's albedo cost by ablation.

Twin of tools/material_kernel_ablation.py on the port. On the bench scene
(tools_torch/scenes.build_scene: the bench.py 8k^2 frame, 1024-slot random
atlas) with a random packed Rgba8 albedo (``default_rng(7)``, 4 channels of
8 bits), times ``meshgen.generate_mesh_fused`` with named pieces of the
albedo kernel (K3; K4 with ``--shade``) removed (ops/kernels.py ``ablate``,
csrc/mesh_fused.cu):

  merged_full   the production albedo kernel (bf16 fast path)
  alb_no_store  the resample kept, only the sum of the channels stored
  alb_no_dots   the resample removed, the channel means stored
  alb_no_unpack every channel the raw word (no shift and mask)
  alb_no_interp the per-vertex window read of the colours removed
  no_dots+store both

The first three and the pair take the exact path, as in the JAX kernel:
their deltas against ``merged_full`` set the exact path against the bf16
fast one, and are not pure removals.

``--shade`` runs the same set on the shaded kernel (K4) through
``generate_mesh_fused(shade_spec=...)``: the material of
material_frame_bench (StandardMaterial on the albedo, its default
lights). Each row is the device time of one call
(``utils/timing.device_time_ms``), then the deltas against the first.
``--cpu`` runs the plain versions on the CPU and prints their host wall,
named so.

Usage: python tools_torch/material_kernel_ablation.py [--cpu] [--shade]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = [
    ("merged_full", frozenset()),
    ("alb_no_store", frozenset({"alb_no_store"})),
    ("alb_no_dots", frozenset({"alb_no_dots"})),
    ("alb_no_unpack", frozenset({"alb_no_unpack"})),
    ("alb_no_interp", frozenset({"alb_no_interp"})),
    ("no_dots+store", frozenset({"alb_no_dots", "alb_no_store"})),
]


def shade_material():
    """The shaded variant's material, material_frame_bench's: a
    StandardMaterial on the albedo (attachment 1) with its default lights,
    as the in-kernel shade's spec (render/material.kernel_shade_spec,
    8-bit channels)."""
    from bevy_terrain_tpu_torch.render.material import (
        StandardMaterial, albedo_material, kernel_shade_spec,
    )

    return kernel_shade_spec(StandardMaterial(base_color=albedo_material(1)), 255.0)


def scene(device, capacity: int = 4096, queue: int = 1024):
    """(tiles, blocks, u, cfg, plan, albedo): the bench frame's refined
    tiles and inputs, and the random packed Rgba8 albedo of its plan."""
    import torch

    from bevy_terrain_tpu_torch.ops import refinement
    from tools_torch.scenes import build_scene

    cfg, plan, blocks, u1, _ = build_scene(capacity, queue, device=device)
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 2**32, tuple(blocks.shape), dtype=np.uint64).astype(np.uint32)
    albedo = torch.from_numpy(packed.view(np.int32)).to(device)
    return refinement.refine_tiles(u1, cfg), blocks, u1, cfg, plan, albedo


def run_variants(inputs, on_card: bool, shade: bool = False, variants=VARIANTS) -> dict:
    """Time ``generate_mesh_fused`` with the albedo (and the shade) per
    variant on ``inputs`` (:func:`scene`); prints each row and the deltas
    against the first. Returns {"timing", "tiles", "ms": {name: ms}}."""
    from bevy_terrain_tpu_torch.ops import meshgen
    from tools_torch.scenes import time_ms

    tiles, blocks, u, cfg, plan, albedo = inputs
    spec = shade_material() if shade else None
    rows: dict = {}
    what = None
    for name, abl in variants:
        def step(abl=abl):
            return meshgen.generate_mesh_fused(
                tiles, blocks, u, cfg, plan, 65535.0, albedo_blocks=albedo, albedo_channels=4,
                albedo_bits=8, shade_spec=spec, ablate=abl)[0]

        ms, what = time_ms(step, label=f"mabl_{name}", on_card=on_card)
        rows[name] = ms
        print(f"{name:16s} {ms * 1e3:10.1f} us {what} (tiles {int(tiles.tile_count)})",
              flush=True)
    full = rows[variants[0][0]]
    print(f"\nattribution (deltas vs {variants[0][0]}{', shaded' if shade else ''}, {what}):")
    for name, _ in variants[1:]:
        print(f"  {name:16s} -{(full - rows[name]) * 1e3:9.1f} us")
    return {"timing": what, "tiles": int(tiles.tile_count), "shade": shade, "ms": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shade", action="store_true",
                    help="the shaded kernel (K4) instead of the albedo kernel (K3)")
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--queue", type=int, default=1024)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    # (the JAX tool's jax_compilation_cache_dir and block_format() have no
    # counterpart: the port has one block layout)
    return run_variants(scene(device, args.capacity, args.queue), not args.cpu, args.shade)


if __name__ == "__main__":
    main()
