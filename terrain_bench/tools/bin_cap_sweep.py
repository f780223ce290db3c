#!/usr/bin/env python3
"""The smallest raster ``bin_cap`` at which no frame of a cell's camera path
drops a binned candidate, on the card.

    python3 terrain_bench/tools/bin_cap_sweep.py --workload <cell> --seeds 0,1,2,3
        [--caps 256,512,1024,2048]

For each seed: the cell's dataset and program ``Terrain`` (every tile
resident), an update at every camera of the path, then the binning of
``render_image`` alone (the frame's mesh with its skirts, the traffic's
``bin_px`` and ``chunk``) at each cap: the candidates the caps drop
(``bin_overflow``), the most over the frames. Prints one JSON line per
seed and a last one with the caps at which no seed drops any.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HOME = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HOME))
sys.path.insert(1, str(HOME.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--caps", default="256,512,1024,2048")
    args = ap.parse_args(argv)

    import torch

    from harness import dataset, manifest, scene
    from bevy_terrain_tpu_torch.render import raster as R

    cell = manifest.cell(manifest.load_json(HOME.parent / "BENCHMARK.json"), HOME.parent,
                         args.workload)
    loop = manifest.module("loops", cell.traffic["loop"])
    caps = [int(c) for c in args.caps.split(",")]
    w, h = cell.traffic["size"]
    knobs = cell.traffic["raster"]
    dev = torch.device("cuda")
    clean = set(caps)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=seed)
        root, _ = dataset.ensure(cell.config, seed, HOME / "_cache" / cell.config["name"], dev)
        terrain = scene.build(cell.config, root, dev)
        scene.preload(terrain)
        worst = {c: 0 for c in caps}
        tiles, overflow = [], 0
        for eye, vp in loop.cameras(ctx):
            out = terrain.update({scene.VIEW: eye}, {scene.VIEW: vp})[scene.VIEW]
            mesh = out.mesh
            pos = R.add_skirts(mesh.positions, spherical=cell.config["model"]["kind"] != "planar")
            vp32 = R._f32_on(vp, dev)
            for c in caps:
                b = R._bin(pos, mesh.tile_mask, vp32, w, h, knobs["bin_px"], c, knobs["chunk"],
                           False, 1e-4)
                worst[c] = max(worst[c], int(b.bin_overflow))
            tiles.append(out.tile_count)
            overflow = max(overflow, out.overflow)
        clean &= {c for c in caps if worst[c] == 0}
        print(json.dumps({"seed": seed, "dropped_most": worst, "tiles": [min(tiles), max(tiles)],
                          "overflow_most": overflow, "tiles_by_camera": tiles,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
        del terrain, out, mesh
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "clean_caps": sorted(clean),
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
