"""The half-grid fetch kernel K7 (``kernels.fetch_resample``): correctness
and timing on its sweep inputs.

Twin of tools/fetch_kernel_sweep.py on the port. Usage::

    python tools_torch/fetch_kernel_sweep.py [waves] [n_blocks] [--cpu]

``waves`` sets ``kernels.HALFGRID_WAVES``, the waves of resident blocks in
the kernel's grid (the JAX tool's first argument, its ``TILES_PER_STEP``;
default: the module's value); ``n_blocks`` the random quads (4096). The
kernel's half-grids for 8192 tiles are held to the staged fetch +
``halfgrid_resample`` (under 1e-2, the JAX tool's assert), then its device
time per call is printed (``utils/timing.device_time_ms``). --cpu runs the
kernel's plain version on the CPU, its row host wall, named so.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TILES = 8192
GROUP = 8  # quad adjacency: one mip of GROUP x GROUP blocks per run


def sweep_inputs(n_blocks: int = 4096, device="cuda"):
    """The JAX tool's inputs (tools/fetch_kernel_sweep.py:28-45) on
    ``device``: ``n_blocks`` random quads of 8x8-block mip runs, 8192 tiles
    at random patch positions with steps 0.5-1 and blend ratios 0-1,
    ``default_rng(0)``. Returns (block_array, ids (F, 4), geom (F, 8))."""
    from bevy_terrain_tpu_torch.ops import patch_sampling

    rng = np.random.default_rng(0)
    N, F, g = n_blocks, TILES, GROUP
    blocks = patch_sampling.quad_rows(
        rng.integers(0, 30000, size=(N, 32, 32)).astype(np.int32), g)
    tl = rng.integers(0, N - g - 2, size=(F,)).astype(np.int32)
    ids = np.stack([tl, tl + 1, tl + g, tl + g + 1], axis=-1).astype(np.int32)
    geom = np.concatenate([
        rng.uniform(0, 30, size=(F, 2)).astype(np.float32),
        rng.uniform(0.5, 1.0, size=(F, 1)).astype(np.float32),
        np.ones((F, 1), np.float32),
        rng.uniform(0.0, 1.0, size=(F, 1)).astype(np.float32),  # blend ratio
        np.zeros((F, 3), np.float32),
    ], axis=1)
    return tuple(torch.from_numpy(a).to(device) for a in (blocks, ids, geom))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("waves", nargs="?", type=int, default=None,
                    help="kernels.HALFGRID_WAVES for the run (the JAX tool's tiles per step)")
    ap.add_argument("n_blocks", nargs="?", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.ops import patch_sampling as ps
    from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig
    from tools_torch.scenes import time_ms

    saved = kernels.HALFGRID_WAVES
    if args.waves is not None:
        kernels.HALFGRID_WAVES = args.waves
    try:
        waves = kernels.HALFGRID_WAVES
        blocks, ids, geom = sweep_inputs(args.n_blocks, device)
        t0 = time.time()
        out = kernels.fetch_resample(blocks, ids, geom)
        if not args.cpu:
            torch.cuda.synchronize()
        print(f"waves={waves} build+run wall: {time.time() - t0:.1f}s", file=sys.stderr)

        # correctness against the staged functions on the same storage
        cfg_like = StaticTerrainConfig(
            spherical=False, side_count=1, lod_count=1, tree_size=1, grid_size=16,
            refinement_count=1, queue_capacity=8, tile_capacity=8, origin_lod=0,
        )
        patch = ps.fetch_patches(blocks, ids)
        want = ps.halfgrid_resample(patch, geom[:, :2], geom[:, 2], cfg_like,
                                    ratio=geom[:, 4])
        err = float((out - want).abs().max())
        print(f"waves={waves} max |kernel - staged| = {err:.6f}")
        if not err < 1e-2:
            raise AssertionError(f"fetch_resample against the staged functions: {err}")

        ms, what = time_ms(kernels.fetch_resample, blocks, ids, geom, label="fetch_sweep",
                           on_card=not args.cpu)
        print(f"waves={waves} {what}: {ms * 1000:.1f} us for F={ids.shape[0]}")
    finally:
        kernels.HALFGRID_WAVES = saved
    return {"waves": waves, "n_blocks": args.n_blocks, "tiles": int(ids.shape[0]),
            "max_abs_err": err, "us": ms * 1000, "timing": what}


if __name__ == "__main__":
    main()
