#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (bevy_terrain_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the planar and the spherical frame from
   ``bevy_terrain_tpu_torch/csrc``.
2. Planar kernel phase, at the frame's real shapes (the bench.py scene: 8k^2
   planar terrain, 5 lods, tile capacity 4096, culled camera, a 1024-slot
   random atlas): refinement and patch plan on the card against the same
   on the CPU, then the kernel against its plain PyTorch version on the
   same inputs, and both timed with CUDA events.
3. Spherical kernel phase, on the Earth scene (tools/earth_frame_bench.py:
   a 6.371e6 m cube sphere, 13 geometry lods over 3 data lods, capacity
   2048, a culled camera at 60 km, a 512-slot random atlas), for the sphere,
   for the WGS84-like ellipsoid and for the sphere at 3 km (the Taylor near
   field): refinement and plan on the card against the CPU (only
   subdivision-threshold ties may differ), the spherical kernel against its
   plain version, timings.
4. Main paths: a synthetic 8k^2 planar dataset, then a synthetic six-side
   planet, each streamed through ``Terrain(config).update`` on the card until
   quiescent; every frame must go through its kernel (launch counts, set to
   0 just before each path and read just after), the output must be finite,
   in range and match the plain version; a torch.profiler pass breaks each
   device stage's time down by kernel.

Exits non-zero (and prints no result line) when there is no CUDA card or
any check fails. The last line of stdout is the JSON result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (wrapper name in ops.kernels, route, source, the TPU kernel it replaces)
KERNELS = [
    ("mesh_fused_planar", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
    ("mesh_fused_spherical", "cuda", "bevy_terrain_tpu_torch/csrc/mesh_fused.cu",
     "bevy_terrain_tpu/ops/pallas_kernels.py:1135"),
]
# kernel vs plain version: both f32, differing in summation order and libm
# ulps; positions reach 8 km, where one f32 ulp is ~0.5 mm
TOL_POS = 5e-3  # m, heights and positions
TOL_UV = 1e-5
# spherical kernel vs plain version, same inputs, same op order per vertex:
# heights differ by the resample's summation order (cuBLAS dots against the
# kernel's 2-tap sums) over a 9 km range; an absolute world position at
# 6.4e6 m rounds to 0.5 m steps, so a height ulp can move it by one step
TOL_SPH_H = 2e-2  # m
TOL_SPH_POS = TOL_SPH_H + 1.0  # m: the height tolerance plus two f32 ulps at 6.4e6 m
TOL_SPH_UV = 1e-6
TOL_SPH_N = 1e-6
TOL_UNIT = 1e-5  # |normal| - 1

TEXTURE_SIZE, BORDER, LOD_COUNT, SIDE = 512, 2, 5, 8000.0
VIEW = (SIDE * 0.03, 120.0, -SIDE * 0.02)

# the Earth scene (tools/earth_frame_bench.py, tools/make_goldens.py::mesh_spherical_case)
RADIUS, SPH_LODS, SPH_DATA_LODS, SPH_ATLAS, SPH_CAPACITY = 6.371e6, 13, 3, 512, 2048
SPH_VIEW = (0.0, 0.0, RADIUS + 60_000.0)
# spherical kernel phase cases: (model, camera altitude m). At 60 km no
# vertex is inside the precision threshold (R / 1000); at 3 km the last
# steps are high-precision and the kernel takes the Taylor near field (the
# frame then overflows its 2048 slots, which the kernel check does not mind)
SPH_CASES = (("sphere", 60_000.0), ("ellipsoid", 60_000.0), ("sphere", 3_000.0))

# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
QUAD_BYTES = 32 * 128 * 4
GV2 = 17 * 17
# f32 operations counted from csrc/mesh_fused.cu (a sqrt, a division, a
# log2 or an exp2 counted as one): per live tile the 33x33 tent resample
# (40 each) and the two 1-2-1 passes (5 each); per vertex the shared morph,
# window and blend chain (120) plus the planar distance and position (52),
# or the two cube-sphere evaluations, the world distance and the outputs
# (132, +38 with the ellipsoid's normal-matrix path), plus the two Taylor
# chains and the near-field distance on high-precision steps (121)
OPS_TILE = 33 * 33 * 40 + 2 * 33 * 33 * 5
OPS_VERTEX = {"planar": 172, "sphere": 252, "ellipsoid": 290}
OPS_VERTEX_HP = 121


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` runs (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, n: int = 20) -> float:
    """Device time of ``fn`` (ms per call): ``n`` calls queued behind a
    ~100 ms sleep kernel, so the host's launch overhead is hidden and the
    CUDA events time the device running them back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cold_ms(fn, n: int = 20) -> float:
    """Median time of ``fn`` with the 50 MB L2 flushed before each call (a
    256 MB write between launches)."""
    import torch

    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    pairs = []
    for _ in range(n):
        scrub.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def mesh_bound(args, n_unique: int, channels: int, live: int, live_hp: int,
               kind: str) -> dict:
    """The least time the card could take for one mesh kernel call on these
    inputs: each input read once (the frame's unique quads, not the whole
    atlas, and the per-tile and frame arrays), each output written once
    (all Fp rows, dead ones as zeros), against the f32 operations that the
    live tiles need."""
    import torch

    small = [a for a in args[1:] if isinstance(a, torch.Tensor)]
    n_tiles = args[1].shape[0]
    nbytes = (n_unique * QUAD_BYTES + sum(a.numel() * a.element_size() for a in small)
              + n_tiles * channels * GV2 * 4)
    ops = live * (OPS_TILE + GV2 * OPS_VERTEX[kind]) + live_hp * GV2 * OPS_VERTEX_HP
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    print(f"  bound: {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms, {ops / 1e9:.3f} GFLOP "
          f"-> {ops_ms:.4f} ms")
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def compare(got, want, what: str) -> float:
    """Max |got - want| over heights+positions, with the uv channels held to
    their own tolerance; raises if either is over. Returns the former."""
    err = (got - want).abs()
    pos = float(err[:, :4].max())
    uv = float(err[:, 4:].max())
    print(f"{what}: max |kernel - plain| heights/positions {pos:.3e} m, uvs {uv:.3e}")
    if not (pos <= TOL_POS and uv <= TOL_UV):
        raise AssertionError(f"{what}: kernel disagrees with the plain version "
                             f"({pos} > {TOL_POS} or {uv} > {TOL_UV})")
    return pos


def compare_spherical(got, want, what: str) -> float:
    """Spherical channels held to their tolerances; returns the max
    |kernel - plain| over heights and positions (m)."""
    err = (got - want).abs()
    errs = {"heights": float(err[:, 0].max()), "positions": float(err[:, 1:4].max()),
            "uvs": float(err[:, 4:6].max()), "normals": float(err[:, 6:9].max())}
    tols = {"heights": TOL_SPH_H, "positions": TOL_SPH_POS, "uvs": TOL_SPH_UV,
            "normals": TOL_SPH_N}
    print(f"{what}: max |kernel - plain| " + ", ".join(
        f"{k} {v:.3e} (tol {tols[k]:.0e})" for k, v in errs.items()))
    over = [k for k in errs if not errs[k] <= tols[k]]
    if over:
        raise AssertionError(f"{what}: kernel disagrees with the plain version on {over}")
    return max(errs["heights"], errs["positions"])


def bench_scene():
    """The bench.py frame: model, view config, camera, uniforms blob inputs."""
    import numpy as np

    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel, frustum

    model = TerrainModel.planar(np.zeros(3), SIDE, 0.0, 250.0)
    vc = TerrainViewConfig(tile_capacity=4096)
    view = np.array(VIEW)
    view_proj = frustum.view_projection(
        view, view + np.array([1000.0, -40.0, 300.0]), np.pi / 3, 16 / 9)
    return model, vc, view, view_proj


def kernel_phase(results: dict) -> None:
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.math import TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement
    from bevy_terrain_tpu_torch.ops import tile_tree
    from bevy_terrain_tpu_torch.ops.params import (
        StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
    )

    model, vc, view, view_proj = bench_scene()
    cfg = StaticTerrainConfig(
        spherical=False, side_count=1, lod_count=LOD_COUNT, tree_size=vc.tree_size,
        grid_size=vc.grid_size, refinement_count=vc.refinement_count,
        queue_capacity=1024, tile_capacity=vc.tile_capacity, origin_lod=vc.origin_lod,
        culling=True,
    )
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, LOD_COUNT,
                                                              vc.tree_size)
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 125.0)
    # fully streamed state: every slot points at a loaded atlas tile
    rng = np.random.default_rng(0)
    entries = np.zeros((1, LOD_COUNT, vc.tree_size, vc.tree_size, 2), np.int32)
    entries[..., 0] = rng.integers(0, 1024, entries.shape[:-1])
    entries[..., 1] = np.arange(LOD_COUNT)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                               view_proj=view_proj)
    plan = patch_sampling.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    n_blocks = 1024 * plan.total_blocks_per_slot
    t0 = time.perf_counter()
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    print(f"kernel phase: block array {tuple(blocks.shape)} int32 "
          f"({blocks.numel() * 4 / 2**30:.2f} GiB) on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    def plan_frame(device, block_array):
        u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 1, LOD_COUNT,
                                  vc.tree_size)
        tiles = refinement.refine_tiles(u, cfg)
        return meshgen.fused_kernel_args(tiles, block_array, u, cfg, plan, 65535.0)

    tiles, batch, args = plan_frame("cuda", blocks)
    ctiles, cbatch, _ = plan_frame("cpu", torch.empty((n_blocks, 32, 128), dtype=torch.int32))
    n = int(tiles.tile_count)
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
        if not torch.equal(getattr(tiles, field).cpu(), getattr(ctiles, field)):
            raise AssertionError(f"refinement on the card differs from the CPU: {field}")
    if not torch.equal(batch.ids.cpu(), cbatch.ids):
        raise AssertionError("patch plan on the card differs from the CPU: ids")
    geom_err = float((batch.geom.cpu() - cbatch.geom).abs().max())
    print(f"kernel phase: {n} tiles (capacity {cfg.tile_capacity}), overflow "
          f"{int(tiles.overflow)}, {int(batch.n_unique)} unique quads; tile list equals "
          f"the CPU's, patch geometry within {geom_err:.1e}")
    if n == 0 or int(tiles.overflow) != 0:
        raise AssertionError("kernel phase frame is empty or overflows")

    got = kernels.mesh_fused_planar(*args)
    torch.cuda.synchronize()
    want = kernels.mesh_fused_planar_reference(*args)
    err = compare(got, want, "mesh_fused_planar")

    # timings: back to back on the device (the frame's quads stay in the
    # 50 MB L2), and with L2 flushed before each launch (a 256 MB write)
    ms = device_ms(lambda: kernels.mesh_fused_planar(*args))
    plain_ms = device_ms(lambda: kernels.mesh_fused_planar_reference(*args))
    flushed_ms = cold_ms(lambda: kernels.mesh_fused_planar(*args))
    frame_ms = cuda_ms(lambda: plan_frame("cuda", blocks), n=20)
    print(f"kernel phase: mesh_fused_planar {ms:.4f} ms (device, L2 warm), {flushed_ms:.4f} ms "
          f"(L2 flushed); plain PyTorch version {plain_ms:.4f} ms (device); "
          f"refine + patch plan {frame_ms:.4f} ms (CUDA events, stream span)")
    bound = mesh_bound(args, int(batch.n_unique), kernels.OUT_CH, n, 0, "planar")
    results["mesh_fused_planar"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
                                        library_ms=None)
    del blocks, args, got, want
    torch.cuda.empty_cache()


# -- spherical kernel phase ---------------------------------------------------


def sphere_model(kind: str):
    """The Earth sphere, or the WGS84-like ellipsoid of models.earth_ellipsoid."""
    import numpy as np

    from bevy_terrain_tpu_torch.math import TerrainModel

    if kind == "sphere":
        return TerrainModel.sphere(np.zeros(3), RADIUS, 0.0, 9000.0)
    return TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9000.0)


def sphere_view(model, altitude: float = 60_000.0):
    """(camera at ``altitude`` above the surface point under SPH_VIEW, its
    60-degree view-projection toward the planet's centre)."""
    import numpy as np

    from bevy_terrain_tpu_torch.math import frustum

    view = model.surface_position(np.array(SPH_VIEW), altitude)
    return view, frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)


def tie_flips(card_nodes: set, cpu_nodes: set, uniforms, cfg) -> tuple[int, float]:
    """Where the card's and the CPU's tile lists differ, every difference
    must be a flipped subdivision of a tile whose subdivision margin sits in
    the planet-scale f32 envelope (|d / t - 1| < 5e-3, the JAX package's
    test_goldens.py tie check), or a child of one. Returns (differing
    nodes, largest margin); raises on a structural difference."""
    import torch

    from bevy_terrain_tpu_torch.ops import coords

    def children(n):
        s, lod, x, y = n
        return {(s, lod + 1, 2 * x + dx, 2 * y + dy) for dx in (0, 1) for dy in (0, 1)}

    diff = card_nodes ^ cpu_nodes
    flipped = []
    for n in sorted(diff):
        other = cpu_nodes if n in card_nodes else card_nodes
        if children(n) <= other:
            flipped.append(n)
    for n in sorted(diff):
        s, lod, x, y = n
        if n not in flipped and (s, lod - 1, x // 2, y // 2) not in flipped:
            raise AssertionError(f"card and CPU tile lists differ structurally at {n}")
    margin = 0.0
    if flipped:
        t = torch.tensor(flipped, dtype=torch.int32)
        side, lod, xy = t[:, 0], t[:, 1], t[:, 2:4].contiguous()
        uv = coords.compute_subdivision_coordinate(side, lod, xy, uniforms.taylor,
                                                   cfg.origin_lod, cfg.side_count)
        dist = coords.approximate_view_distance(side, lod, xy, uv, uniforms, cfg)
        thresh = uniforms.subdivision_distance / coords.tile_count(lod)
        margin = float((dist.double() / thresh.double() - 1.0).abs().max())
        if margin >= 5e-3:
            raise AssertionError(f"a card/CPU tile flip is not a threshold tie ({margin})")
    return len(diff), margin


def sphere_kernel_phase(results: dict) -> None:
    import numpy as np
    import torch

    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModelApproximation
    from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement
    from bevy_terrain_tpu_torch.ops import tile_tree
    from bevy_terrain_tpu_torch.ops.params import (
        StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
    )

    vc = TerrainViewConfig(tile_capacity=SPH_CAPACITY)
    plan = patch_sampling.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    n_blocks = SPH_ATLAS * plan.total_blocks_per_slot
    rng = np.random.default_rng(1)
    blocks = torch.from_numpy(
        rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)).cuda()
    errs = []
    for kind, altitude in SPH_CASES:
        what = f"{kind} at {altitude / 1e3:g} km"
        model = sphere_model(kind)
        view, view_proj = sphere_view(model, altitude)
        cfg = StaticTerrainConfig(
            spherical=True, side_count=6, lod_count=SPH_LODS, tree_size=vc.tree_size,
            grid_size=vc.grid_size, refinement_count=vc.refinement_count,
            queue_capacity=2048, tile_capacity=SPH_CAPACITY, origin_lod=vc.origin_lod,
            high_precision=True, ellipsoidal=kind == "ellipsoid", culling=True,
        )
        origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, SPH_LODS,
                                                                  vc.tree_size)
        approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 4500.0)
        # fully streamed state over 3 data lods (test_fused_mesh.py:124-126)
        entries = np.zeros((6, SPH_LODS, vc.tree_size, vc.tree_size, 2), np.int32)
        entries[..., 0] = rng.integers(0, SPH_ATLAS, entries.shape[:-1])
        entries[..., 1] = np.minimum(np.arange(SPH_LODS), SPH_DATA_LODS - 1)[None, :, None, None]
        blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                                   view_proj=view_proj)

        def plan_frame(device, block_array, blob=blob, cfg=cfg):
            u = unpack_frame_uniforms(torch.from_numpy(blob).to(device), 6, SPH_LODS,
                                      vc.tree_size)
            tiles = refinement.refine_tiles(u, cfg)
            return (u, *meshgen.fused_kernel_args(tiles, block_array, u, cfg, plan,
                                                  65535.0))

        _, tiles, batch, args = plan_frame("cuda", blocks)
        cu, ctiles, cbatch, _ = plan_frame(
            "cpu", torch.empty((n_blocks, 32, 128), dtype=torch.int32))
        n, cn = int(tiles.tile_count), int(ctiles.tile_count)

        def nodes(t, count):
            return {tuple(r) for r in torch.stack(
                [t.tile_side[:count], t.tile_lod[:count], t.tile_xy[:count, 0],
                 t.tile_xy[:count, 1]], dim=-1).cpu().tolist()}

        n_diff, margin = tie_flips(nodes(tiles, n), nodes(ctiles, cn), cu, cfg)
        same_plan = n_diff == 0 and torch.equal(batch.ids.cpu(), cbatch.ids)
        if n_diff == 0 and not same_plan:
            raise AssertionError(f"{what}: patch plan on the card differs from the CPU")
        live_hp = int(((args[5] == 2).repeat_interleave(kernels.TILES_PER_STEP)
                       & (torch.arange(args[1].shape[0], device="cuda") < n)).sum())
        print(f"sphere kernel phase ({what}): {n} tiles (capacity {SPH_CAPACITY}; CPU {cn}), "
              f"overflow {int(tiles.overflow)}, {int(batch.n_unique)} unique quads, "
              f"{live_hp} tiles on high-precision steps; {n_diff} nodes differ from the "
              f"CPU's (threshold ties, largest margin {margin:.2e}); patch plan "
              f"{'equals' if same_plan else 'follows'} the CPU's")
        if n <= 100 or (altitude == SPH_CASES[0][1] and int(tiles.overflow) != 0):
            raise AssertionError(f"{what}: spherical kernel phase frame is small or overflows")
        if altitude < SPH_CASES[0][1] and live_hp == 0:
            raise AssertionError(f"{what}: no high-precision step")

        got = kernels.mesh_fused_spherical(*args)
        torch.cuda.synchronize()
        want = kernels.mesh_fused_spherical_reference(*args)
        errs.append(compare_spherical(got, want, f"mesh_fused_spherical ({what})"))
        norm = torch.linalg.vector_norm(got[:n, 6:9].double(), dim=1)
        if float((norm - 1.0).abs().max()) > TOL_UNIT:
            raise AssertionError(f"{what}: kernel normals are not unit length")
        if got[n:].any():
            raise AssertionError(f"{what}: tiles past tile_count are not zero")

        ms = device_ms(lambda: kernels.mesh_fused_spherical(*args))
        plain_ms = device_ms(lambda: kernels.mesh_fused_spherical_reference(*args))
        flushed_ms = cold_ms(lambda: kernels.mesh_fused_spherical(*args))
        frame_ms = cuda_ms(lambda: plan_frame("cuda", blocks), n=10)
        print(f"sphere kernel phase ({what}): mesh_fused_spherical {ms:.4f} ms (device, L2 "
              f"warm), {flushed_ms:.4f} ms (L2 flushed); plain PyTorch version "
              f"{plain_ms:.4f} ms (device); unpack + refine + patch plan {frame_ms:.4f} ms "
              f"(CUDA events, stream span)")
        bound = mesh_bound(args, int(batch.n_unique), kernels.SPH_CH, n, live_hp, kind)
        if (kind, altitude) == SPH_CASES[0]:
            results["mesh_fused_spherical"] = dict(ms=ms, plain_ms=plain_ms, **bound,
                                                   library_ms=None)
        del args, got, want
    results["mesh_fused_spherical"]["max_abs_err"] = max(errs)
    del blocks
    torch.cuda.empty_cache()


# -- main paths ----------------------------------------------------------------


def stream(terrain, view, view_proj, kernel_name: str, what: str):
    """Stream ``terrain`` to quiescence, then 30 timed frames. The launch
    counts are set to 0 just before and read just after; every frame must
    have launched ``kernel_name``. Returns (last output, launches, update
    walls in s)."""
    import torch

    from bevy_terrain_tpu_torch.ops import kernels

    for name, *_ in KERNELS:
        getattr(kernels, name).launches = 0
    frames = 0
    t0 = time.perf_counter()
    for i in range(300):
        terrain.update({"cam": view}, {"cam": view_proj})
        frames += 1
        if i > 3 and not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    walls = []
    for _ in range(30):
        t0 = time.perf_counter()
        out = terrain.update({"cam": view}, {"cam": view_proj})["cam"]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        frames += 1
    counts = {name: getattr(kernels, name).launches for name, *_ in KERNELS}
    print(f"{what}: streamed to quiescence in {stream_s:.1f} s; {frames} frames, "
          f"launches {counts}")
    if counts[kernel_name] != frames:
        raise AssertionError(f"{kernel_name} launched {counts[kernel_name]} times in "
                             f"{frames} frames")
    return out, counts[kernel_name], walls


def stage_timing(terrain, what: str, n: int, hmin: float, hmax: float, walls) -> None:
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]
    blob = terrain._last_blobs["cam"]

    def device_stage():
        terrain.frame_step(height.block_array, blob, cfg, height.patch_plan,
                           height.config.format.max_value)

    stage_ms = cuda_ms(device_stage, n=20)
    print(f"{what}: {n} tiles, heights [{hmin:.2f}, {hmax:.2f}] m; update "
          f"{statistics.median(walls) * 1e3:.3f} ms median wall (host prologue + "
          f"device stage + sync); unpack + refine + plan + mesh {stage_ms:.4f} ms "
          f"(CUDA events, stream span)")
    profile_stage(device_stage, what)


def main_path_phase() -> int:
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset

    model, vc, view, view_proj = bench_scene()
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        tiles = generate_planar_dataset("smoke", LOD_COUNT, att, root=tmp)
        print(f"main path: wrote {len(tiles)} tiles of {TEXTURE_SIZE}^2 R16 "
              f"(lods 0-{LOD_COUNT - 1}) in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=LOD_COUNT, model=model, atlas_size=1024,
                               path="smoke", attachments=(att,), assets_root=tmp)
        terrain = Terrain(config, device="cuda")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=vc.tile_capacity),
                         queue_capacity=1024, culling=True)
        out, launches, walls = stream(terrain, view, view_proj, "mesh_fused_planar",
                                      "main path")

        n = out.tile_count
        if n <= 0 or out.overflow != 0:
            raise AssertionError(f"main path frame: tile_count {n}, overflow {out.overflow}")
        mesh = out.mesh
        for field in ("heights", "positions", "uvs"):
            if not bool(torch.isfinite(getattr(mesh, field)).all()):
                raise AssertionError(f"non-finite {field}")
        h = mesh.heights[:n]
        hmin, hmax = float(h.min()), float(h.max())
        if not (model.min_height <= hmin and hmax <= model.max_height):
            raise AssertionError(f"heights [{hmin}, {hmax}] outside the model's range")
        compare(out.raw_mesh, kernels.mesh_fused_planar_reference(*out.mesh_inputs),
                "main path last frame")
        stage_timing(terrain, "main path", n, hmin, hmax, walls)
        return launches


def sphere_main_path_phase() -> int:
    """A synthetic six-side planet (3 data lods of 512^2 R16 tiles) streamed
    through ``Terrain(config)`` (the card by default) under the Earth
    scene's camera."""
    import torch

    from bevy_terrain_tpu_torch import Terrain
    from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
    from bevy_terrain_tpu_torch.ops import kernels
    from bevy_terrain_tpu_torch.utils.synthetic import generate_spherical_dataset

    model = sphere_model("sphere")
    view, view_proj = sphere_view(model)
    att = AttachmentConfig(name="height", texture_size=TEXTURE_SIZE, border_size=BORDER,
                           mip_level_count=4)
    what = "sphere main path"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sphere_") as tmp:
        t0 = time.perf_counter()
        tiles = generate_spherical_dataset("smoke_sphere", SPH_DATA_LODS, att, root=tmp)
        print(f"{what}: wrote {len(tiles)} tiles of {TEXTURE_SIZE}^2 R16 on 6 sides (lods "
              f"0-{SPH_DATA_LODS - 1}) in {time.perf_counter() - t0:.1f} s")
        config = TerrainConfig(lod_count=SPH_LODS, model=model, atlas_size=SPH_ATLAS,
                               path="smoke_sphere", attachments=(att,), assets_root=tmp)
        terrain = Terrain(config)
        if terrain.device.type != "cuda":
            raise AssertionError(f"Terrain(config) runs on {terrain.device}, not the card")
        terrain.add_view("cam", TerrainViewConfig(tile_capacity=SPH_CAPACITY),
                         queue_capacity=2048, culling=True)
        out, launches, walls = stream(terrain, view, view_proj, "mesh_fused_spherical", what)

        n = out.tile_count
        if n <= 100 or out.overflow != 0:
            raise AssertionError(f"{what} frame: tile_count {n}, overflow {out.overflow}")
        mesh = out.mesh
        for field in ("heights", "positions", "uvs", "normals"):
            if not bool(torch.isfinite(getattr(mesh, field)[:n]).all()):
                raise AssertionError(f"{what}: non-finite {field}")
        h = mesh.heights[:n]
        hmin, hmax = float(h.min()), float(h.max())
        if not (model.min_height <= hmin and hmax <= model.max_height):
            raise AssertionError(f"{what}: heights [{hmin}, {hmax}] outside the model's range")
        norm = torch.linalg.vector_norm(mesh.normals[:n].double(), dim=-1)
        unit_err = float((norm - 1.0).abs().max())
        if unit_err > TOL_UNIT:
            raise AssertionError(f"{what}: normals off unit length by {unit_err}")
        compare_spherical(out.raw_mesh,
                          kernels.mesh_fused_spherical_reference(*out.mesh_inputs),
                          f"{what} last frame")
        stage_timing(terrain, what, n, hmin, hmax, walls)
        return launches


def profile_stage(device_stage, what: str) -> None:
    """Kernel time by name over 10 device stages (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device_stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            device_stage()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted(events, key=lambda e: getattr(e, "device_time_total", 0.0), reverse=True)
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    n_kernels = sum(e.count for e in events if getattr(e, "self_device_time_total", 0.0) > 0)
    print(f"profile ({what}): {total / 10 / 1e3:.4f} ms device kernel time per stage, "
          f"{n_kernels / 10:.0f} device ops per stage")
    for i, e in enumerate(rows):
        if getattr(e, "self_device_time_total", 0.0) > 0 and (i < 15 or "mesh_fused" in e.key):
            print(f"profile:   {e.key[:60]:60s} {e.count // 10:4d}x "
                  f"{e.self_device_time_total / 10 / 1e3:.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bevy_terrain_tpu_torch.ops import kernels

    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} ({torch.cuda.device_count()} visible); nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = kernels.build_library(verbose=True)
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    results: dict = {}
    kernel_phase(results)
    sphere_kernel_phase(results)
    counts = {"mesh_fused_planar": main_path_phase(),
              "mesh_fused_spherical": sphere_main_path_phase()}

    print(json.dumps({"kernels": [
        {"name": k, "route": route, "source": src, "replaces": rep,
         "launches": counts[k], **results[k]}
        for k, route, src, rep in KERNELS
    ]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
