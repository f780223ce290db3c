"""Multi-view (``bevy_terrain_tpu_torch.parallel``) against the JAX package.

The scene of tests/test_multi_view.py: a 3-lod synthetic planar dataset
(512^2 R16 tiles, 1000 m, a 64-slot atlas), the view config capacity 512,
``morph_distance=2.0``, ``blend_distance=1.0``, queue 1024, and the first 4
of its 8 seeded views. The JAX ``MultiViewTerrain`` runs on 4 virtual CPU
devices, one view each; the port's on the CPU. Both take the staged grid
path there (the JAX one ``fetch_patches_xla`` + ``halfgrid_resample``, or
its sharded fetch; the port ``fetch_patches`` + ``halfgrid_resample``, or
its sharded fetch), ``pallas_sampling`` being off on the CPU in both.
Tolerances:

* tile sets exact; heights and positions per tile key within 1e-3 m and
  uvs within 1e-6, the tolerances of tests/test_torch_staged_mesh.py for
  ``generate_mesh_grid``;
* with ``pallas_sampling=True`` (the fused mesh kernel's plain version),
  each view bit-equal to the port's ``Terrain`` stepping the same views
  over the same atlas, and within 2e-2 m of the JAX staged frame (the
  fused-vs-staged yardstick, tests/test_multi_view.py:150-161);
* ``fetch_patches_sharded`` bit-equal to the plain gather and to the JAX
  function; ``shard_blocks`` the JAX layout, exactly;
* ``multi_view_frame_step`` on ``entry._build``'s 4-lod sphere with 4
  distinct cameras: tile counts exact, heights within 0.2 m and positions
  within 6.0 m of the JAX step (the per-vertex path's yardstick near the
  surface, tests/test_torch_spherical_mesh.py::JAX_TOL["sphere_near"]).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu.parallel import MultiViewTerrain as JMultiViewTerrain
from bevy_terrain_tpu.parallel import fetch_patches_sharded as jfetch_patches_sharded
from bevy_terrain_tpu.parallel import multi_view_frame_step as jmulti_view_frame_step
from bevy_terrain_tpu.parallel import shard_blocks as jshard_blocks
from bevy_terrain_tpu_torch import Terrain
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.parallel import (
    MultiViewTerrain, fetch_patches_sharded, multi_view_frame_step, shard_blocks,
)
from bevy_terrain_tpu_torch.parallel.multi_view import stack_uniforms
from tests.test_multi_view import _make_config, _stream, _view_positions
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import JAX_TOL, tile_rows

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_VIEWS = 4
TOL_STAGED = dict(heights=1e-3, positions=1e-3, uvs=1e-6)
TOL_FUSED_STAGED = 2e-2


def _positions():
    return dict(list(_view_positions().items())[:N_VIEWS])


def _view_config():
    return TerrainViewConfig(tile_capacity=512, morph_distance=2.0, blend_distance=1.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(JAX config, port config): one dataset on disk, read by both."""
    root = tmp_path_factory.mktemp("assets")
    jconfig = _make_config(root)
    att = AttachmentConfig(name="height", texture_size=512, border_size=2, mip_level_count=4,
                           format=AttachmentFormat.R16)
    config = TerrainConfig(
        lod_count=3, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        atlas_size=64, path="terrains/mv", attachments=(att,), assets_root=str(root))
    return jconfig, config


def _port_mvt(config, **kw):
    return MultiViewTerrain(config, list(_positions()), devices=["cpu"] * N_VIEWS,
                            view_config=_view_config(), queue_capacity=1024, **kw)


@pytest.fixture(scope="module", params=[False, True], ids=["replicated", "sharded"])
def frames(request, scene):
    """(port MultiViewTerrain, port frame, JAX frame) of one atlas mode."""
    from bevy_terrain_tpu.config import TerrainViewConfig as JTerrainViewConfig

    jconfig, config = scene
    positions = _positions()
    jmvt = JMultiViewTerrain(
        jconfig, list(positions), devices=jax.devices()[:N_VIEWS],
        view_config=JTerrainViewConfig(tile_capacity=512, morph_distance=2.0,
                                       blend_distance=1.0),
        queue_capacity=1024, shard_atlas=request.param)
    assert not jmvt.cfg.pallas_sampling
    mvt = _port_mvt(config, shard_atlas=request.param)
    assert not mvt.cfg.pallas_sampling  # the CPU default: the staged grid path
    return mvt, _stream(mvt, positions), _stream(jmvt, positions)


def _hold_per_key(got, want, tols, what):
    """Tile sets equal; each field within its tolerance per tile key.
    Returns the largest differences."""
    n = got.tile_count
    assert n == want.tile_count > 0, what
    rows, rows_j = tile_rows(got.tiles, n), tile_rows(want.tiles, n)
    assert set(rows) == set(rows_j), what
    keys = sorted(rows)
    i = np.array([rows[k] for k in keys])
    j = np.array([rows_j[k] for k in keys])
    worst = {}
    for field, atol in tols.items():
        a = getattr(got.mesh, field).numpy()[i]
        b = np.asarray(getattr(want.mesh, field))[j]
        worst[field] = float(np.abs(a - b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{what} {field}")
    return worst


def test_frames_match_the_jax_multi_view_terrain(frames):
    mvt, outs, jouts = frames
    for v in _positions():
        worst = _hold_per_key(outs[v], jouts[v], TOL_STAGED, v)
        print(f"{'sharded' if mvt.shard_atlas else 'replicated'} {v}: {outs[v].tile_count} "
              f"tiles, max |port - JAX| " + ", ".join(f"{k} {x:.3e}" for k, x in worst.items()))
    counts = [outs[v].tile_count for v in outs]
    assert len(set(counts)) > 1  # distinct cameras refine differently


def test_views_share_one_atlas(frames):
    mvt, outs, _ = frames
    total_requested = sum(int(t.tile_requested.sum()) for t in mvt.tile_trees.values())
    resident = len(mvt.atlas.state.tile_states)
    assert 0 < resident <= total_requested  # residency deduplicated across views
    stacked = outs["v0"]._s
    F = mvt.cfg.tile_capacity
    assert stacked["mesh"].heights.shape == (N_VIEWS, F, 17, 17)
    assert stacked["tiles"].tile_count.shape == (N_VIEWS,)
    store = mvt.atlas.attachments[0].block_array
    blocks = mvt.terrain.blocks()
    if mvt.shard_atlas:  # 64 slots x 84 blocks divide by 4: the shards are a view
        assert blocks.shape[:2] == (N_VIEWS, store.shape[0] // N_VIEWS)
        assert blocks.data_ptr() == store.data_ptr()
    else:  # the atlas's own array, no copy
        assert blocks is store
    # the views' blobs went to the device in one (V, L) int32 copy
    blob_rows = mvt.terrain.last_stacked
    assert blob_rows.shape[0] == N_VIEWS and blob_rows.dtype == torch.int32
    for i, v in enumerate(_positions()):
        assert mvt.terrain._last_blobs[v].data_ptr() == blob_rows[i].data_ptr()


def test_fused_views_equal_the_single_view_terrain(scene):
    """``pallas_sampling=True``: each view's step is ``Terrain.frame_step``
    (the fused kernel's plain version on the CPU) + ``fused_to_grid``; a
    ``Terrain`` with the same views over the same atlas gives the same
    bits. Against the JAX staged frame with the fused kernel's per-vertex
    blend (``blend_per_vertex``, as tests/test_multi_view.py compares
    them), the fused-vs-staged yardstick."""
    from bevy_terrain_tpu.config import TerrainViewConfig as JTerrainViewConfig

    jconfig, config = scene
    positions = _positions()
    jmvt = JMultiViewTerrain(
        jconfig, list(positions), devices=jax.devices()[:N_VIEWS],
        view_config=JTerrainViewConfig(tile_capacity=512, morph_distance=2.0,
                                       blend_distance=1.0),
        queue_capacity=1024, blend_per_vertex=True)
    jouts = _stream(jmvt, positions)
    mvt = _port_mvt(config, pallas_sampling=True)
    _stream(mvt, positions)
    ref = Terrain(config, device="cpu")
    ref.atlas = mvt.atlas
    for v in positions:
        ref.add_view(v, _view_config(), queue_capacity=1024, pallas_sampling=True)
    _stream(ref, positions)
    outs, ref_outs = mvt.update(positions), ref.update(positions)
    for v in positions:
        a, b = outs[v], ref_outs[v]
        assert b.raw_mesh is not None  # the single-view fused path
        for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
            assert torch.equal(getattr(a.tiles, field), getattr(b.tiles, field)), (v, field)
        for field in ("positions", "normals", "uvs", "heights", "tile_mask"):
            assert torch.equal(getattr(a.mesh, field), getattr(b.mesh, field)), (v, field)
        worst = _hold_per_key(a, jouts[v], dict(heights=TOL_FUSED_STAGED,
                                                positions=TOL_FUSED_STAGED), v)
        print(f"fused {v}: max |port fused - JAX staged| "
              + ", ".join(f"{k} {x:.3e}" for k, x in worst.items()))


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_fetch_patches_sharded_is_the_plain_gather(n):
    """N = 37 blocks (divides by 1 only) of random int32 words, positive
    and negative: the sum over owners equals the plain gather bit for bit,
    and the JAX sharded fetch and layout on n virtual devices."""
    rng = np.random.default_rng(n)
    blocks = rng.integers(-2 ** 31, 2 ** 31 - 1, (37, 32, 128), dtype=np.int64).astype(np.int32)
    blocks[:8] = rng.integers(0, 65535, (8, 32, 128))
    ids = rng.integers(0, 37, (50, 4)).astype(np.int32)
    ids[:37, 0] = np.arange(37)  # every block, the last shard's tail too
    shards = shard_blocks(n, torch.from_numpy(blocks))
    per = -(-37 // n)
    assert shards.shape == (n, per, 32, 128)
    got = fetch_patches_sharded(shards, torch.from_numpy(ids))
    want = ps.fetch_patches(torch.from_numpy(blocks), torch.from_numpy(ids))
    assert torch.equal(got, want)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("atlas",))
    jshards = jshard_blocks(mesh, jnp.asarray(blocks))
    np.testing.assert_array_equal(shards.reshape(-1, 32, 128).numpy(), np.asarray(jshards))
    jgot = np.asarray(jfetch_patches_sharded(mesh, jshards, jnp.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_shard_blocks_is_a_view_when_n_divides():
    blocks = torch.arange(8 * 32 * 128, dtype=torch.int32).reshape(8, 32, 128)
    shards = shard_blocks(4, blocks)
    assert shards.data_ptr() == blocks.data_ptr() and shards.shape == (4, 2, 32, 128)
    blocks[5] = -1  # an in-place upload shows through
    assert bool((shards[2, 1] == -1).all())
    with pytest.raises(ValueError):
        shard_blocks(0, blocks)


@pytest.mark.parametrize("fetch", ["fetch_patches", "sharded"])
def test_generate_mesh_grid_fetch_hook(fetch):
    """``generate_mesh_grid(fetch_fn=ps.fetch_patches)`` on small_frame
    against the JAX function with ``fetch_fn=fetch_patches_xla`` (the staged
    functions at grid size 16 in both); the sharded fetch (5 shards of the
    16-slot store, which does not divide by 5, and the global ``n_blocks``)
    gives the plain fetch's bits."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame(blend_per_vertex=True)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    tb = torch.from_numpy(blocks)
    plain, ptiles = meshgen.generate_mesh_grid(refinement.refine_tiles(u, cfg), tb, u, cfg,
                                               plan, 65535.0, fetch_fn=ps.fetch_patches)
    if fetch == "sharded":
        assert blocks.shape[0] % 5
        mesh, tiles = meshgen.generate_mesh_grid(
            refinement.refine_tiles(u, cfg), shard_blocks(5, tb), u, cfg, plan, 65535.0,
            fetch_fn=fetch_patches_sharded, n_blocks=blocks.shape[0])
        for field in ("positions", "normals", "uvs", "heights", "tile_mask"):
            assert torch.equal(getattr(mesh, field), getattr(plain, field)), field
        for field in ("tile_side", "tile_lod", "tile_xy", "tile_count"):
            assert torch.equal(getattr(tiles, field), getattr(ptiles, field)), field
        return

    @jax.jit
    def jframe(blob, blocks):
        ju = junpack(blob, 1, LODS, 8)
        return jmeshgen.generate_mesh_grid(jrefinement.refine_tiles(ju, jcfg), blocks, ju,
                                           jcfg, jplan, 65535.0, fetch_fn=jps.fetch_patches_xla)

    jmesh, jtiles = jframe(jnp.asarray(blob), jnp.asarray(blocks))

    class Frame:
        def __init__(self, tiles, mesh):
            self.tiles, self.mesh, self.tile_count = tiles, mesh, int(tiles.tile_count)

    worst = _hold_per_key(Frame(ptiles, plain), Frame(jtiles, jmesh), TOL_STAGED, fetch)
    print("generate_mesh_grid(fetch_fn=...): max |port - JAX| " + ", ".join(
        f"{k} {x:.3e}" for k, x in worst.items()))


def _sphere_uniforms(make_frame_uniforms, tile_tree_ops, TerrainModel, TerrainModelApproximation,
                     TerrainViewConfig, lod_count, **kw):
    """The 4 distinct spherical cameras of the JAX dryrun_multichip."""
    model = TerrainModel.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
    vc = TerrainViewConfig(grid_size=4, tile_capacity=128)
    out = []
    for i in range(N_VIEWS):
        d = np.array([np.cos(i), 0.3 * np.sin(2 * i), np.sin(i)])
        view = model.position_local_to_world(d / np.linalg.norm(d), 2000.0 + 500.0 * i)
        origins, vt_int, vt_frac = tile_tree_ops.compute_view_anchors(model, view, lod_count,
                                                                     vc.tree_size)
        approx = TerrainModelApproximation.compute(model, view, vc.origin_lod, 4500.0)
        entries = np.zeros((6, lod_count, vc.tree_size, vc.tree_size, 2), np.int32)
        out.append(make_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac,
                                       vc, **kw))
    return out


def test_multi_view_frame_step_matches_jax():
    import __graft_entry__ as g
    from bevy_terrain_tpu import math as jmath
    from bevy_terrain_tpu.config import TerrainViewConfig as JTerrainViewConfig
    from bevy_terrain_tpu.ops import tile_tree as jtile_tree
    from bevy_terrain_tpu.ops.params import make_frame_uniforms as jmake
    from bevy_terrain_tpu_torch.entry import sphere_views

    shape = dict(tile_capacity=128, queue_capacity=512, lod_count=4, grid_size=4)
    jcfg, _, jslab = g._build(**shape)
    ju = _sphere_uniforms(jmake, jtile_tree, jmath.TerrainModel, jmath.TerrainModelApproximation,
                          JTerrainViewConfig, jcfg.lod_count)
    cfg, u, slab = sphere_views(N_VIEWS, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jpos, jheights, jcounts = (np.asarray(x) for x in jmulti_view_frame_step(
        jax.devices()[:N_VIEWS], jcfg, ju, jslab))
    positions, heights, counts = multi_view_frame_step(["cpu"] * N_VIEWS, cfg, u, slab)
    assert positions.shape == jpos.shape and positions.shape[0] == N_VIEWS
    assert counts.tolist() == jcounts.tolist() and all(c > 0 for c in counts.tolist())
    h_tol, p_tol, _ = JAX_TOL["sphere_near"]
    for i, n in enumerate(counts.tolist()):
        dh = np.abs(heights[i, :n].numpy() - jheights[i, :n]).max()
        dp = np.abs(positions[i, :n].numpy() - jpos[i, :n]).max()
        print(f"multi_view_frame_step view {i}: {n} tiles, heights {dh:.3e} m, "
              f"positions {dp:.3e} m")
        assert dh <= h_tol and dp <= p_tol
    # one FrameUniforms broadcast to every view: each view is view 0's frame
    bpos, bheights, bcounts = multi_view_frame_step(["cpu"] * 2, cfg, u[0], slab,
                                                    views_per_device=2)
    assert bpos.shape[0] == 4 and bcounts.tolist() == [counts[0]] * 4
    for i in range(4):
        assert torch.equal(bpos[i], positions[0]) and torch.equal(bheights[i], heights[0])
    stacked = stack_uniforms(u)
    assert stacked.view_world_position.shape == (N_VIEWS, 3)
    assert stacked.taylor.c.shape == (N_VIEWS, 6, 3)
    assert torch.equal(stacked.entries[2], u[2].entries)


def test_two_distinct_devices_raise(scene):
    """Distinct cards need one process each (parallel/launch.py): without a
    group they raise ValueError, pointing to the launcher; one device slot
    per view; ``interpret=True`` (the plain versions) on a CUDA device."""
    _, config = scene
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="launch"):
        MultiViewTerrain(config, ["a", "b"], devices=devices)
    with pytest.raises(ValueError, match="launch"):
        multi_view_frame_step(devices, None, None, None)
    with pytest.raises(ValueError):  # one device slot per view
        MultiViewTerrain(config, ["a", "b"], devices=["cpu"])
    with pytest.raises(ValueError, match="interpret"):
        MultiViewTerrain(config, ["a", "b"], devices=[devices[0]] * 2, interpret=True)


def test_runs_on_the_card_by_default(scene):
    """No fallback: the default devices are the card's."""
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    _, config = scene
    with pytest.raises((RuntimeError, AssertionError)):
        MultiViewTerrain(config, ["a", "b"])
