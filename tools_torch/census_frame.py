"""Profile the bench frame and print its top device kernels by self time.

Twin of tools/census_frame.py on the port: the bench.py frame (8k^2 planar,
5 lods, a 1024-slot random atlas) at tile capacity 8192 without culling,
through ``refine_tiles`` and the staged mesh ``generate_mesh_grid`` (K6,
``kernels.fetch_resample_cached``, once a frame). Prints the frame's
device total and its top 30 kernels by self CUDA time, from
``torch.profiler``, kernels only (``utils/timing.device_breakdown``). The
JAX tool's trace parser reads XLA op names; the port's rows are CUDA
kernel names. --cpu runs the frame on the CPU and prints its ops by self
host time, named so.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CAPACITY = QUEUE = 8192


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from bevy_terrain_tpu_torch.ops import meshgen, refinement
    from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
    from tools_torch import scenes

    cfg, vc, blob, plan, rng = scenes.bench_frame(capacity=CAPACITY, queue=QUEUE)
    cfg = dataclasses.replace(cfg, culling=False)
    blocks = torch.from_numpy(rng.integers(
        0, 65535, (scenes.ATLAS_SLOTS * plan.total_blocks_per_slot, 32, 128)).astype(
            np.int32)).to(device)
    uniforms = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 1, scenes.LOD_COUNT,
                                     vc.tree_size)

    def frame():
        tiles = refinement.refine_tiles(uniforms, cfg)
        return meshgen.generate_mesh_grid(tiles, blocks, uniforms, cfg, plan, 65535.0)

    _, tiles = frame()
    result = scenes.top_ops(frame, label="census_frame", on_card=not args.cpu)
    return {"tiles": int(tiles.tile_count), "capacity": CAPACITY, **result}


if __name__ == "__main__":
    main()
