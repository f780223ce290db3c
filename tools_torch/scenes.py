"""The bench scene of the frame tools, and how they time a call.

The bench.py frame: an 8 km planar terrain (5 lods of 512^2 R16 tiles with
4 mips, border 2) under a 60-degree culled camera at 120 m, tile capacity
4096, a fully streamed 1024-slot atlas (atlas entries drawn from
``default_rng(0)``). :func:`build_scene` is the twin of
tools/multi_view_bench.py's ``build_scene`` that refine_bench,
material_frame_bench and raster_bench import; chip_smoke.py's kernel
phases build the same frame from :func:`bench_frame`. One difference: the
random height blocks. :func:`build_scene` draws them from a fresh
``default_rng(0)``, as the JAX scene does; chip_smoke.py draws them from
the generator :func:`bench_frame` returns, after the atlas entries, so its
``digest:`` lines stay those of the earlier trees. The JAX scene's
``pallas_sampling`` flag has no counterpart here: the port's pipeline
reads it nowhere.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation, frustum
from bevy_terrain_tpu_torch.ops import patch_sampling, tile_tree
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
)
from bevy_terrain_tpu_torch.utils.timing import benchmark, device_time_ms

TEXTURE_SIZE, BORDER, LOD_COUNT, SIDE = 512, 2, 5, 8000.0
ATLAS_SLOTS = 1024
# the bench camera and its look direction; the second view of the JAX scene
VIEW, TOWARD = (SIDE * 0.03, 120.0, -SIDE * 0.02), (1000.0, -40.0, 300.0)
VIEW2, TOWARD2 = (-SIDE * 0.11, 300.0, SIDE * 0.07), (-800.0, -60.0, 500.0)


def bench_scene(view=VIEW, toward=TOWARD, capacity: int = 4096):
    """The bench terrain's model, view config, camera and view projection."""
    model = TerrainModel.planar(np.zeros(3), SIDE, 0.0, 250.0)
    vc = TerrainViewConfig(tile_capacity=capacity)
    view = np.array(view)
    view_proj = frustum.view_projection(view, view + np.array(toward), np.pi / 3, 16 / 9)
    return model, vc, view, view_proj


def bench_frame(view=VIEW, toward=TOWARD, capacity: int = 4096, queue: int = 1024):
    """The bench frame's static config, packed uniforms and patch plan, with
    the generator (``default_rng(0)``) that drew its atlas entries."""
    model, vc, view, view_proj = bench_scene(view, toward, capacity)
    cfg = StaticTerrainConfig(
        spherical=False, side_count=1, lod_count=LOD_COUNT, tree_size=vc.tree_size,
        grid_size=vc.grid_size, refinement_count=vc.refinement_count,
        queue_capacity=queue, tile_capacity=vc.tile_capacity, origin_lod=vc.origin_lod,
        culling=True,
    )
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, LOD_COUNT,
                                                              vc.tree_size)
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 125.0)
    # fully streamed state: every slot points at a loaded atlas tile
    rng = np.random.default_rng(0)
    entries = np.zeros((1, LOD_COUNT, vc.tree_size, vc.tree_size, 2), np.int32)
    entries[..., 0] = rng.integers(0, ATLAS_SLOTS, entries.shape[:-1])
    entries[..., 1] = np.arange(LOD_COUNT)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                               view_proj=view_proj)
    plan = patch_sampling.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    return cfg, vc, blob, plan, rng


def build_scene(capacity: int = 4096, queue: int = 1024, device="cuda"):
    """(cfg, plan, blocks, u1, u2) on ``device``: the static config, the
    patch plan, random (ATLAS_SLOTS x blocks per slot, 32, 128) int32 height
    blocks, and the frame uniforms of the bench camera (u1) and of a second
    camera (u2)."""
    cfg, vc, blob1, plan, _ = bench_frame(capacity=capacity, queue=queue)
    blob2 = bench_frame(VIEW2, TOWARD2, capacity, queue)[2]
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(
        0, 65535, (ATLAS_SLOTS * plan.total_blocks_per_slot, 32, 128)).astype(np.int32))
    u1, u2 = (unpack_frame_uniforms(torch.from_numpy(b).to(device), 1, LOD_COUNT,
                                    vc.tree_size) for b in (blob1, blob2))
    return cfg, plan, blocks.to(device), u1, u2


def time_ms(fn, *args, label: str = "bench", on_card: bool = True):
    """(ms, what): the device time of ``fn(*args)`` per call on the card
    (:func:`device_time_ms`), or on the CPU the least host wall of a few
    calls (:func:`benchmark`; not a device time)."""
    if on_card:
        return device_time_ms(fn, *args, label=label), "device"
    return benchmark(fn, *args, n=3, warmup=1)["min_ms"], "CPU wall"
