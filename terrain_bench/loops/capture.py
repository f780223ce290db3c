"""Closed-loop capture: one client drawing the frames of a camera path, one
frame at a time.

A frame is ``Terrain.update`` for the frame's camera, ``Terrain.render_image``
(per-pixel textured PBR at the traffic's size and raster knobs), then a
synchronize; the image stays on the device. The cameras come from
``cameras/<path kind>.py``; the window visits them in the order ``(phase +
visit_stride * i) mod n``, the phase drawn from the seed, so any stretch of
frames samples the whole path.

Set-up: the dataset (``harness/dataset.py``), the program's ``Terrain`` with
every tile resident (``harness/scene.py``), one update at every camera (the
tile counts read there pick the frames compared) and two whole frames.
Then the window of ``seconds``: every frame timed from the call to the
synchronize; a frame fails when its tile list overflows its capacity or its
binning drops a candidate. The products of ``check.frames`` cameras are
kept: the one with the most tiles and others drawn from the seed, each the
last time the window drew it.

With ``trace``: after the window, ``trace.frames`` frames with a
synchronize after the update (the update's host time), then as many more, plus a first and ``TAIL`` last ones not read,
under ``torch.profiler`` with marker kernels (``harness/trace.py``).

Last, with the program's state freed, the plain reference (``reference/``)
draws the kept frames again from the same files and cameras, with the
approximate height replayed over every camera the program was given, and
``harness/check.py`` compares them.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import check, dataset, scene, stats, trace
from reference.data import Dataset

TAIL = 2


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cameras(ctx) -> list:
    """[(eye, view_proj)] of the traffic's camera path (``cameras/<kind>.py``)."""
    from harness import manifest

    w, h = ctx.traffic["size"]
    path = ctx.traffic["path"]
    return manifest.module("cameras", path["kind"]).cameras(path, ctx.config, ctx.seed, w / h)


def visit_order(n: int, stride: int, seed: int) -> list:
    if np.gcd(n, stride) != 1:
        raise ValueError(f"visit_stride {stride} does not visit all {n} cameras")
    phase = int(np.random.default_rng([int(seed), 103]).integers(n))
    return [(phase + stride * i) % n for i in range(n)]


def pick(counts: list, frames: int, seed: int) -> list:
    """The cameras compared: the one with the most tiles, then others
    drawn from the seed."""
    first = int(np.argmax(counts))
    rng = np.random.default_rng([int(seed), 104])
    rest = [int(i) for i in rng.permutation(len(counts)) if i != first]
    return [first] + rest[:frames - 1]


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    size = tuple(tr["size"])
    knobs = dict(tr["raster"])
    root, written = dataset.ensure(cfg, ctx.seed, ctx.cache, dev)
    cams = cameras(ctx)
    order = visit_order(len(cams), tr["visit_stride"], ctx.seed)

    terrain = scene.build(cfg, root, dev, **getattr(ctx, "program_overrides", {}))
    scene.preload(terrain)
    V = scene.VIEW
    seq = []  # every camera the program is asked for, in order

    def update(k):
        eye, vp = cams[k]
        seq.append(k)
        return terrain.update({V: eye}, {V: vp})[V]

    def render(k, out):
        return terrain.render_image(V, out, cams[k][1], *size, **knobs)

    counts = [update(k).tiles.tile_count for k in range(len(cams))]
    for k in order[:2]:
        render(k, update(k))
    _sync(dev)
    counts = [int(c) for c in counts]
    compared = pick(counts, tr["check"]["frames"], ctx.seed)
    setup_s = time.perf_counter() - ctx.t0

    # the window
    fails = torch.zeros((), dtype=torch.int32, device=dev)
    kept, kept_at, walls, i = {}, {}, [], 0
    start = time.perf_counter()
    while True:
        k = order[i % len(order)]
        t = time.perf_counter()
        out = update(k)
        image, r = render(k, out)
        fails += ((out.tiles.overflow != 0) | (r.bin_overflow != 0)).to(torch.int32)
        _sync(dev)
        end = time.perf_counter()
        walls.append(end - t)
        if k in compared:
            kept[k], kept_at[k] = (out, image), len(seq) - 1
        i += 1
        if end - start >= ctx.seconds:
            break
    window_s = end - start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {
        "attempted": len(walls), "failed": int(fails),
        "memory_peak_bytes": int(peak), "dataset_bytes_written": written,
        "end_to_end": {"frames_per_s": stats.rate(len(walls), window_s),
                       "frame_p90_ms": stats.percentile(walls, 90) * 1e3,
                       "setup_s": setup_s},
    }
    if ctx.trace:
        result.update(traced(ctx, terrain, cams, order, i, update, render, dev))

    frames = [check.products(*kept[k]) for k in compared if k in kept]
    missing = [k for k in compared if k not in kept]
    del kept, out, image, r, update, render, terrain
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    chk = tr["check"]
    seen = [k for k in compared if k not in missing]
    t_ref = time.perf_counter()
    data = Dataset(cfg, root, dev)
    hs = check.heights(cfg, data, [cams[k][0] for k in seq])
    want = [check.reference_frame(cfg, tr, data, *cams[k], hs[kept_at[k]], dev) for k in seen]
    ref_s = time.perf_counter() - t_ref
    numbers = check.worst([check.compare(g, w) for g, w in zip(frames, want)])
    result["checks"] = {n: {"value": numbers[n], "limit": limit}
                        for n, limit in chk["limits"].items()}
    result["checks"]["frames_missing"] = {"value": float(len(missing)), "limit": 0.0}
    result["correct"] = not missing and check.verdict(numbers, chk["limits"])
    result["compared"] = {"cameras": compared, "tiles": [counts[k] for k in compared],
                          "most_tiles": max(counts), "fewest_tiles": min(counts),
                          "tiles_diff": numbers["tiles_diff"], "near_m": numbers["near_m"],
                          "reference_s": ref_s}
    result["numbers"] = numbers
    if ctx.control:
        ctl = [check.reference_frame(cfg, tr, data, *cams[k], hs[kept_at[k]], dev, control=True)
               for k in seen]
        result["control"] = check.worst([check.compare(c, w) for c, w in zip(ctl, want)])
    return result


def traced(ctx, terrain, cams, order, i, update, render, dev) -> dict:
    """The per-layer readings after the window (module docstring)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = ctx.traffic["trace"]["frames"]
    upd_ms = []
    for j in range(n):
        k = order[(i + j) % len(order)]
        t = time.perf_counter()
        out = update(k)
        _sync(dev)
        upd_ms.append((time.perf_counter() - t) * 1e3)
        render(k, out)
        _sync(dev)
    i += n
    live = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for j in range(n + 1 + TAIL):
            k = order[(i + j) % len(order)]
            with record_function("tb::update"):
                trace.mark()
                out = update(k)
            with record_function("tb::render"):
                trace.mark()
                render(k, out)
            live.append(out.tiles.tile_count)
            with record_function("tb::sync"):
                _sync(dev)
        trace.mark()
        _sync(dev)
    dev_recs, host_recs = trace.records(prof)
    frames, window = trace.split_frames(dev_recs, n)
    for f, c in zip(frames, live[1:n + 1]):
        f["live"] = int(c)
    busy_s, window_s = trace.busy(dev_recs, window) / 1e6, (window[1] - window[0]) / 1e6
    return {
        "trace": {"update_ms": upd_ms, "frames": frames,
                  "busy_s": busy_s, "window_s": window_s,
                  "config": ctx.config, "traffic": ctx.traffic},
        "busy_s": busy_s, "window_s": window_s,
        "breakdown": {"device_ops": trace.top_ops(dev_recs, window),
                      "idle_gaps": trace.idle_by_host(dev_recs, host_recs, window)},
    }
