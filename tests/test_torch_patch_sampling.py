"""Patch plan: the torch package against the JAX package.

On the fused-mesh test frame (tests/test_fused_mesh.py ``small_frame``:
planar, 3 lods, random atlas entries, capacity 64) both packages plan the
patch fetches from the same packed uniforms and refined tiles; the sorted
tile list and every PatchBatch field must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops import refinement, tile_tree
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, pack_frame_uniforms
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms

TEXTURE_SIZE, BORDER, LODS, SIDE = 512, 2, 3, 1000.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test file's torch CPU work on one thread. The suite runs several
    test processes at once, and a thread pool per process oversubscribes the
    cores; the checks do not depend on the thread count. Other test files
    import this fixture to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_frame(**cfg_kw):
    """The small_frame scene of tests/test_fused_mesh.py, packed into one
    uniform blob. Returns (blob, blocks, cfg, jax cfg, plan, jax plan)."""
    model = TerrainModel.planar(np.zeros(3), SIDE, 0.0, 100.0)
    vc = TerrainViewConfig(tile_capacity=64)
    view = np.array([30.0, 60.0, -20.0])
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, LODS, 8)
    approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 50.0)
    rng = np.random.default_rng(1)
    entries = np.zeros((1, LODS, 8, 8, 2), np.int32)
    entries[..., 0] = rng.integers(0, 16, (1, LODS, 8, 8))
    entries[..., 1] = np.arange(LODS)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc)
    plan = ps.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    blocks = rng.integers(0, 65535, (16 * plan.total_blocks_per_slot, 32, 128)).astype(np.int32)
    kw = dict(
        spherical=False, side_count=1, lod_count=LODS, tree_size=vc.tree_size,
        grid_size=16, refinement_count=8, queue_capacity=256,
        tile_capacity=vc.tile_capacity, origin_lod=vc.origin_lod, **cfg_kw,
    )
    jplan = jps.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    assert tuple(plan) == tuple(jplan)
    return blob, blocks, StaticTerrainConfig(**kw), JStaticConfig(**kw), plan, jplan


def plan_both(**cfg_kw):
    blob, blocks, cfg, jcfg, plan, jplan = small_frame(**cfg_kw)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    tiles, batch = ps.plan_patch_batch(
        refinement.refine_tiles(u, cfg), u, cfg, plan, blocks.shape[0])
    jtiles, jbatch = jps.plan_patch_batch(
        jrefinement.refine_tiles(ju, jcfg), ju, jcfg, jplan, blocks.shape[0], 64)
    return tiles, batch, jtiles, jbatch


@pytest.fixture(scope="module")
def planned():
    # the slice's configuration: per-vertex blend (the fused kernel's)
    return plan_both(blend_per_vertex=True)


def test_sorted_tiles_exact(planned):
    tiles, _, jtiles, _ = planned
    assert int(tiles.tile_count) == int(jtiles.tile_count) > 0
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
        got = getattr(tiles, field)
        want = np.asarray(getattr(jtiles, field))
        assert got.dtype == torch.int32, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)


@pytest.mark.parametrize("field", ["uq", "slots", "rank_lo", "rank_hi", "n_unique", "geom", "ids"])
def test_patch_batch_field_exact(planned, field):
    _, batch, _, jbatch = planned
    got = getattr(batch, field).numpy()
    want = np.asarray(getattr(jbatch, field))
    assert got.dtype == want.dtype and got.shape == want.shape, field
    np.testing.assert_array_equal(got, want, err_msg=field)


def test_tile_center_blend_ratio():
    """Without per-vertex blend the plan carries each tile's center blend
    ratio in geom[:, 4]. That column goes through log2, which XLA's CPU
    backend rounds less exactly than torch (about a third of its results
    are one ulp off the correctly rounded value), and the ratio divides the
    log2 by -blend_range (0.2), so it agrees to 1e-6; every other column
    stays exact."""
    _, batch, _, jbatch = plan_both(blend_per_vertex=False)
    got, want = batch.geom.numpy(), np.asarray(jbatch.geom)
    np.testing.assert_array_equal(np.delete(got, 4, axis=1), np.delete(want, 4, axis=1))
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-6)
    for field in ("uq", "slots", "ids", "n_unique"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      np.asarray(getattr(jbatch, field)))


def test_patch_geometry_matches_jax():
    """patch_geometry on random tiles (lods, atlas lods, window uvs)."""
    rng = np.random.default_rng(3)
    n = 512
    tile_lod = rng.integers(0, 12, n).astype(np.int32)
    atlas_lod = np.minimum(tile_lod, rng.integers(0, 12, n)).astype(np.int32)
    atlas_index = rng.integers(-1, 64, n).astype(np.int32)
    window_uv = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    plan = ps.make_patch_plan(TEXTURE_SIZE, 4, BORDER)
    cfg = small_frame()[2]
    got = ps.patch_geometry(*(torch.from_numpy(a) for a in (atlas_index, tile_lod, atlas_lod,
                                                            window_uv)), plan, cfg)
    want = jps.patch_geometry(*(jnp.asarray(a) for a in (atlas_index, tile_lod, atlas_lod,
                                                         window_uv)),
                              jps.make_patch_plan(TEXTURE_SIZE, 4, BORDER), small_frame()[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
