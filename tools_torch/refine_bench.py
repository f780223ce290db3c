"""Refinement-stage timing: where do the refine microseconds go?

Twin of tools/refine_bench.py on the port. Times refine_tiles alone (the
planar 8k^2 bench scene of tools_torch/scenes.py) and two structural
ablations:

  sort_only   the dense stable 5-column sort on precomputed columns
  pred_only   the flat predicate batch alone (visible & should_divide)

Rows are device time on the card (``utils/timing.device_time_ms``); with
``--cpu``, the least host wall of a few calls on the CPU.

Usage: python tools_torch/refine_bench.py [--cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else "cuda"
    # (the JAX tool's jax_compilation_cache_dir has no counterpart: nothing
    # here is compiled ahead, the kernels' build is cached in build/kernels/)

    from bevy_terrain_tpu_torch.ops import coords, refinement
    from tools_torch.scenes import build_scene, time_ms

    on_card = device == "cuda"
    cfg, plan, blocks, u1, _ = build_scene(device=device)
    del blocks  # refinement reads the uniforms only

    t = refinement.refine_tiles(u1, cfg)
    n = int(t.tile_count)
    rows = {}
    ms, what = time_ms(refinement.refine_tiles, u1, cfg, label="refine_planar",
                       on_card=on_card)
    rows["refine_tiles"] = ms
    print(f"planar refine_tiles   {ms * 1e3:8.1f} us {what} (tiles {n})", flush=True)

    # flat predicate batch alone
    Ld = refinement.dense_level_cap(cfg)
    S = cfg.side_count
    np_side, np_lod, np_x, np_y = [], [], [], []
    for k in range(Ld + 1):
        c = 1 << k
        grid = np.mgrid[0:S, 0:c, 0:c].astype(np.int32)
        np_side.append(grid[0].reshape(-1))
        np_lod.append(np.full(S * c * c, k, np.int32))
        np_y.append(grid[1].reshape(-1))
        np_x.append(grid[2].reshape(-1))
    flat_side, flat_lod, flat_x, flat_y = (
        torch.from_numpy(np.concatenate(a)).to(device) for a in (np_side, np_lod, np_x, np_y))
    flat_xy = torch.stack([flat_x, flat_y], dim=-1)

    def pred_only(u):
        vis = coords.tile_visible(flat_side, flat_lod, flat_xy, u, cfg)
        div = refinement.should_be_divided(flat_side, flat_lod, flat_xy, u, cfg)
        return vis & div

    ms, what = time_ms(pred_only, u1, label="refine_pred", on_card=on_card)
    rows["pred_only"] = ms
    print(f"planar pred batch     {ms * 1e3:8.1f} us {what} "
          f"({flat_side.shape[0]} lanes)", flush=True)

    # the dense 5-column stable sort alone (category randomized)
    rng = np.random.default_rng(3)
    cat0 = torch.from_numpy(rng.integers(0, 3, flat_side.shape[0]).astype(np.int32)).to(device)

    def sort_only(catv):
        return refinement._stable_sort(catv, flat_side, flat_lod, flat_x, flat_y)[0]

    ms, what = time_ms(sort_only, cat0, label="refine_sort", on_card=on_card)
    rows["sort_only"] = ms
    print(f"planar dense sort x5  {ms * 1e3:8.1f} us {what}", flush=True)

    # single-column packed-key sort for comparison
    def sort_packed(catv):
        c = 1 << Ld
        key = ((((catv * (Ld + 1) + flat_lod) * S + flat_side) * c
                + flat_y) * c + flat_x)
        return torch.sort(key).values

    ms, what = time_ms(sort_packed, cat0, label="refine_sort_packed", on_card=on_card)
    rows["sort_packed"] = ms
    print(f"planar dense sort x1  {ms * 1e3:8.1f} us {what} (packed key)", flush=True)

    # (Earth spherical refine timing lives in tools_torch/earth_frame_bench.py,
    # as in the JAX tools: the planar decomposition above is what drives the
    # sort/predicate design decisions.)
    return {"tiles": n, "ms": rows, "timing": what}


if __name__ == "__main__":
    main()
