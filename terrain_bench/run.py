#!/usr/bin/env python3
"""The benchmark of bevy_terrain_tpu_torch, the PyTorch and CUDA port.

    python3 terrain_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for. Reads ``BENCHMARK.json``; the cell names a configuration (its file), a
traffic mix (``traffic/<name>.json``), and through the traffic a loop
(``loops/<loop>.py``), which sets up, runs the window, and compares what
the window produced with the frozen reference. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, each read
by ``metrics/<name>.py`` (a reader that finds nothing returns None and the
metric is left out). The last line of standard output is the result; the
last lines of standard error give each number compared beside its limit.
Exits non-zero with no result without enough cards, when the program is
missing, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HOME = Path(__file__).resolve().parent
ROOT = HOME.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bevy_terrain_tpu")


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's, Flax's or the JAX package's,
    compared whole (``bevy_terrain_tpu_torch`` is not ``bevy_terrain_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch writes stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(HOME))
    sys.path.insert(1, str(ROOT))

    from harness import manifest

    bench = manifest.load_json(ROOT / "BENCHMARK.json")
    cell = manifest.cell(bench, ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this process sees {have}",
              file=sys.stderr)
        return 2
    try:
        import bevy_terrain_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test does not import: {e}", file=sys.stderr)
        return 2

    loop = manifest.module("loops", cell.traffic["loop"])
    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                          cache=HOME / "_cache" / cell.config["name"], t0=T0,
                          control=False)
    res = loop.run(ctx)

    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = manifest.module("metrics", m["name"]).read(res["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["compared"] = res["compared"]
    line["checks"] = res["checks"]
    print(f"dataset: {res['dataset_bytes_written']} bytes written", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
