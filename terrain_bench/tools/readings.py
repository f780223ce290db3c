#!/usr/bin/env python3
"""The numbers ``correct`` compares, for many seeds in one process, and the
control's: the readings the limits in ``traffic/<mix>.json`` are set from.

    python3 terrain_bench/tools/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 5] [--control]

Each seed runs the cell's loop as a run does (set-up, a window of
``--seconds`` at the cell's own load, the comparison with the reference);
with ``--control`` the control too: the reference with each layer's
product held in bfloat16, put in the program's place
(``harness/check.py``). ``--set config.view.tile_capacity=16384`` (or
``traffic.path.above="sphere"``, a JSON value) changes the cell for a look
outside it; ``--program pallas_sampling=false`` hands the program's view
an option (here: the path without hand kernels). One JSON line per seed.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--program", action="append", default=[])
    args = ap.parse_args(argv)

    import torch

    from harness import manifest

    cell = manifest.cell(manifest.load_json(HOME.parent / "BENCHMARK.json"), HOME.parent,
                         args.workload)
    for item in args.set:
        path, value = item.split("=", 1)
        part, *keys = path.split(".")
        node = {"config": cell.config, "traffic": cell.traffic}[part]
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = json.loads(value)
    loop = manifest.module("loops", cell.traffic["loop"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=seed,
                              seconds=args.seconds, trace=False, device="cuda:0",
                              cache=HOME / "_cache" / cell.config["name"],
                              t0=time.perf_counter(), control=args.control,
                              program_overrides={k: json.loads(v) for k, v in
                                                 (p.split("=", 1) for p in args.program)})
        res = loop.run(ctx)
        print(json.dumps({
            "seed": seed, "correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "compared": res["compared"],
            "program": res["numbers"], "control": res.get("control"),
            "card": torch.cuda.get_device_name(0)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
