"""Device-side queries and the best-loaded lookup: torch against JAX.

1. Function by function on identical numpy inputs: ``coords.lookup_best`` /
   ``compute_tile_tree_uv``, ``sampling.sample_trilinear``,
   ``mip_level_from_grad``, ``sample_normal`` (planar and per-face TBN),
   ``pick_cube_face`` / ``sigmoid_warp_forward`` on tensors.
2. ``Terrain.query_heights`` / ``query_attachment`` on streamed terrains (a
   planar terrain, the same terrain translated as tests/test_pipeline.py:384,
   and a six-side planet with an Rgba8 albedo), port on the CPU:

   * against the JAX functions (``ops/sampling.query_heights`` /
     ``query_attachment``) on the port's own blob and slabs, blend on and
     off: heights within 1e-4 m planar and 2e-2 m on the planet (values in
     :data:`TOL_JAX` with the measured gaps), colours within 1e-5;
   * against the host sampling API (terrain_data/sampling_api.py, f64) point
     by point, as tests/test_pipeline.py:341-362: within 1e-2 m (that test's
     own bound is 0.35 m; values in :data:`TOL_HOST`).
3. ``tile_tree_lod`` frames: the patch plan and the data-lod debug view with
   the best-loaded walk in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.math import coordinate as jcoordinate
from bevy_terrain_tpu.ops import coords as jcoords
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops import sampling as jsampling
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu_torch.config import AttachmentConfig, AttachmentFormat
from bevy_terrain_tpu_torch.math import coordinate
from bevy_terrain_tpu_torch.ops import coords, meshgen, refinement, sampling
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.terrain_data.sampling_api import sample_attachment, sample_height
from bevy_terrain_tpu_torch.utils.synthetic import (
    generate_planar_dataset, generate_spherical_dataset,
)
from tests.test_torch_material import _jax_cfg, _jax_mesh, _jax_tiles
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_staged_pipeline import _stream, _terrains

R = 6.371e6


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- 1. function by function -----------------------------------------------------


def _random_coords(rng, n, lods, sides=1):
    lod = rng.integers(0, lods, n).astype(np.int32)
    xy = (rng.integers(0, 1 << 16, (n, 2)) % (1 << lod)[:, None]).astype(np.int32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    side = rng.integers(0, sides, n).astype(np.int32)
    return side, lod, xy, uv


@pytest.mark.parametrize("tree_size", [4, 8])
def test_lookup_best_matches_jax(tree_size):
    """Random coordinates against 7 lods of random entries whose tree
    windows (``tree_size`` tiles wide, around a view point) cover the whole
    side only at the coarse lods: the walk's tree uv, and the entry it ends
    on, exactly (integer and power-of-two arithmetic)."""
    _, _, cfg, _, _, _ = small_frame()
    lods = 7
    cfg = dataclasses.replace(cfg, lod_count=lods, tree_size=tree_size)
    rng = np.random.default_rng(11)
    view = np.array([0.37, 0.61])
    origins = np.zeros((1, lods, 2), np.int32)
    for lod in range(lods):
        count = 1 << lod
        corner = np.round(view * count - tree_size / 2).astype(np.int64)
        origins[0, lod] = np.clip(corner, 0, max(count - tree_size, 0))
    entries = np.zeros((1, lods, tree_size, tree_size, 2), np.int32)
    entries[..., 0] = rng.integers(-1, 50, entries.shape[:-1])
    entries[..., 1] = np.where(entries[..., 0] < 0, -1,
                               rng.integers(0, lods, entries.shape[:-1]))
    side, lod, xy, uv = _random_coords(rng, 6000, lods)
    got = coords.lookup_best(_t(entries), _t(origins), _t(side), _t(lod), _t(xy), _t(uv), cfg)
    want = jcoords.lookup_best(jnp.array(entries), jnp.array(origins), jnp.array(side),
                               jnp.array(lod), jnp.array(xy), jnp.array(uv), _jax_cfg(cfg))
    for g, w, name in zip(got, want, ("index", "lod", "xy", "uv")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool((got[0] < 0).any()) and bool((got[0] >= 0).any())
    # the walk stops at several lods: the candidates' tree uvs leave the window
    inside = []
    for cand in range(1, lods):
        c = coords.coordinate_change_lod(_t(lod), _t(xy), _t(uv), cand)
        tuv = coords.compute_tile_tree_uv(_t(origins), _t(side), *c, cfg)
        jc = jcoords.coordinate_change_lod(jnp.array(lod), jnp.array(xy), jnp.array(uv), cand)
        jtuv = jcoords.compute_tile_tree_uv(jnp.array(origins), jnp.array(side), *jc,
                                            _jax_cfg(cfg))
        np.testing.assert_array_equal(tuv.numpy(), np.asarray(jtuv))
        inside.append(float(((tuv > 0) & (tuv < 1)).all(dim=-1).float().mean()))
    assert inside[0] == 1.0 and inside[-1] < 0.5, inside


def test_sample_trilinear_and_mip_level_match_jax():
    """A 3-mip chain of random uint8 and uint16 slabs at random uvs and
    fractional levels (some outside the chain), and a one-mip chain."""
    rng = np.random.default_rng(12)
    for dtype, channels, full in ((np.uint16, 1, 65535.0), (np.uint8, 4, 255.0)):
        slabs = [rng.integers(0, int(full) + 1, (5, 32 >> m, 32 >> m, channels)).astype(dtype)
                 for m in range(3)]
        index = rng.integers(-1, 5, (40, 25)).astype(np.int32)
        uv = rng.uniform(-0.05, 1.05, (40, 25, 2)).astype(np.float32)
        level = rng.uniform(-0.5, 2.7, (40, 25)).astype(np.float32)
        for chain in (slabs, slabs[:1]):
            got = sampling.sample_trilinear([_t(s) for s in chain], _t(index), _t(uv),
                                            _t(level), full).numpy()
            want = np.asarray(jsampling.sample_trilinear(
                [jnp.array(s) for s in chain], jnp.array(index), jnp.array(uv),
                jnp.array(level), full))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert not got[index < 0].any() and got.max() > 0.8
    dx = rng.normal(0, 0.01, (300, 2)).astype(np.float32)
    dy = rng.normal(0, 0.002, (300, 2)).astype(np.float32)
    dx[:5] = 0.0
    dy[:5] = 0.0  # the 1e-12 clamp
    got = sampling.mip_level_from_grad(_t(dx), _t(dy), 512).numpy()
    want = np.asarray(jsampling.mip_level_from_grad(jnp.array(dx), jnp.array(dy), 512))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
def test_sample_normal_matches_jax(spherical):
    """Four height taps and the TBN (the per-face one on a sphere) on a
    random height slab: unit normals within 1e-5."""
    blob, _, cfg, _, _, _ = small_frame()
    cfg = dataclasses.replace(cfg, spherical=spherical, side_count=6 if spherical else 1)
    u = unpack_frame_uniforms(_t(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    rng = np.random.default_rng(13)
    n = 500
    slab = rng.integers(0, 65536, (6, 64, 64, 1)).astype(np.uint16)
    index = rng.integers(0, 6, n).astype(np.int32)
    side = rng.integers(0, 6 if spherical else 1, n).astype(np.int32)
    lod = rng.integers(0, 5, n).astype(np.int32)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    vn = rng.normal(size=(n, 3)).astype(np.float32)
    args = (60.0 / 64.0, 2.0 / 64.0, 64)
    got = sampling.sample_normal(_t(slab), _t(index), _t(side), _t(lod), _t(uv), _t(vn), u,
                                 cfg, *args).numpy()
    want = np.asarray(jsampling.sample_normal(
        jnp.array(slab), jnp.array(index), jnp.array(side), jnp.array(lod), jnp.array(uv),
        jnp.array(vn), ju, _jax_cfg(cfg), *args))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=0, atol=1e-5)
    assert float(np.abs(got[:, 0]).max()) > 0.1  # tilted, not the flat normal


def test_face_pick_and_warp_on_tensors():
    rng = np.random.default_rng(14)
    v = rng.normal(size=(2000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    side = coordinate.pick_cube_face(_t(v), xp=torch)
    assert side.dtype == torch.int32
    np.testing.assert_array_equal(side.numpy(), coordinate.pick_cube_face(v))
    np.testing.assert_array_equal(side.numpy(),
                                  np.asarray(jcoordinate.pick_cube_face(jnp.array(v), xp=jnp)))
    raw = rng.uniform(-1, 1, (2000, 2)).astype(np.float32)
    got = coordinate.sigmoid_warp_forward(_t(raw), xp=torch).numpy()
    want = np.asarray(jcoordinate.sigmoid_warp_forward(jnp.array(raw), xp=jnp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


# -- 2. queries on streamed terrains --------------------------------------------

SIZE, MAX_HEIGHT = 1000.0, 100.0
PLANAR_ATT = dict(name="height", texture_size=64, border_size=2, mip_level_count=3)
SPH_ATTS = [dict(name="height", texture_size=256, border_size=2, mip_level_count=3),
            dict(name="albedo", texture_size=256, border_size=2, mip_level_count=3,
                 format="RGBA8")]
# scene -> (model, attachments, terrain kwargs, view config, view kwargs, camera)
SCENES = {
    "planar": (("planar", (np.zeros(3), SIZE, 0.0, MAX_HEIGHT)), [PLANAR_ATT],
               dict(lod_count=4, atlas_size=128, path="terrains/q"),
               dict(tile_capacity=512), dict(queue_capacity=1024),
               np.array([50.0, 80.0, -120.0])),
    "translated": (("planar", (np.array([30.0, -100.0, -20.0]), SIZE, 0.0, MAX_HEIGHT)),
                   [PLANAR_ATT], dict(lod_count=4, atlas_size=128, path="terrains/q"),
                   dict(tile_capacity=512), dict(queue_capacity=1024),
                   np.array([80.0, -20.0, -140.0])),
    "planet": (("sphere", (np.zeros(3), R, 0.0, 9000.0)), SPH_ATTS,
               dict(lod_count=6, atlas_size=128, path="planet_q"),
               dict(tile_capacity=512), dict(queue_capacity=1024),
               np.array([0.0, 0.0, R + 60_000.0])),
}
# |port - JAX function| on the same blob and slabs: (heights m, colours).
# Same f32 chain in both; what differs is XLA's fused multiply-adds and its
# log2 in the blend ratio. Measured: planar 7.6e-6 m (0 without the blend),
# translated 3.8e-6 m, planet 2.0e-3 m (one f32 step of a 7 km height is
# 4.9e-4 m) and 2.4e-7 of full scale.
TOL_JAX = {"planar": (1e-4, 1e-5), "translated": (1e-4, 1e-5), "planet": (2e-2, 1e-5)}
# |port - host sampling API (f64)|, heights m. Measured: 6.5e-5 m on the
# planar terrains, 1.0e-3 m on the planet (its smooth field hides the f32
# face uv's error at 6.4e6 m); colours 1.7e-7. tests/test_pipeline.py holds
# the JAX function to 0.35 m.
TOL_HOST = {"planar": 1e-2, "translated": 1e-2, "planet": 1e-2}


def _points(scene, n, seed):
    rng = np.random.default_rng(seed)
    model, *_ = SCENES[scene]
    if scene == "planet":
        # around the camera's nadir and across the neighbouring faces
        d = rng.normal(size=(n, 3)) * np.array([0.6, 0.6, 0.2]) + np.array([0.0, 0.0, 1.0])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return d * (R + rng.uniform(0.0, 20_000.0, (n, 1)))
    origin = model[1][0]
    return np.stack([origin[0] + rng.uniform(-480, 480, n),
                     origin[1] + rng.uniform(0.0, 60.0, n),
                     origin[2] + rng.uniform(-480, 480, n)], axis=-1)


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Each scene's port Terrain on the CPU, streamed at its camera."""
    root = tmp_path_factory.mktemp("torch_queries")
    generate_planar_dataset("terrains/q", 4, AttachmentConfig(**PLANAR_ATT), root=str(root))
    for att in SPH_ATTS:
        fmt = getattr(AttachmentFormat, att.get("format", "R16"))
        generate_spherical_dataset("planet_q", 3, AttachmentConfig(**{**att, "format": fmt}),
                                   root=str(root))
    out = {}
    for scene, (model, atts, terrain_kw, vc, view_kw, view) in SCENES.items():
        port, _ = _terrains(root, model, atts, terrain_kw, vc, view_kw)
        _stream(port, view)
        out[scene] = port
    return out


def _jax_inputs(terrain, blend):
    cfg = dataclasses.replace(terrain._static_cfgs["cam"], blend=blend)
    blob = terrain.last_uniform_blob("cam")
    ju = junpack(jnp.asarray(blob), cfg.side_count, cfg.lod_count, cfg.tree_size)
    return cfg, _jax_cfg(cfg), ju


def _slab(att):
    s = att.slabs[0]
    if s.dtype == torch.uint16:
        return s.view(torch.int16).numpy().view(np.uint16)
    return s.numpy()


@pytest.mark.parametrize("blend", [True, False], ids=["blend", "no_blend"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_query_heights_match_jax_function(streamed, scene, blend):
    terrain = streamed[scene]
    cfg, jcfg, ju = _jax_inputs(terrain, blend)
    terrain._static_cfgs["cam"], saved = cfg, terrain._static_cfgs["cam"]
    try:
        pts = _points(scene, 3000, 21)
        got = terrain.query_heights("cam", pts)
        again = terrain.query_heights("cam", torch.from_numpy(pts.astype(np.float32)))
    finally:
        terrain._static_cfgs["cam"] = saved
    height = terrain.atlas.attachments[0]
    want = np.asarray(jsampling.query_heights(
        jnp.asarray(_slab(height)), ju, jcfg, jnp.asarray(pts.astype(np.float32)),
        height.config.scale, height.config.offset))
    assert isinstance(got, torch.Tensor) and got.shape == (3000,) and got.dtype == torch.float32
    assert torch.equal(got, again)  # numpy or tensor positions
    err = float(np.abs(got.numpy() - want).max())
    model = terrain.config.model
    print(f"{scene} blend={blend}: query_heights max |port - JAX| {err:.3e} m, heights in "
          f"[{float(got.min()):.2f}, {float(got.max()):.2f}]")
    assert err <= TOL_JAX[scene][0]
    assert model.min_height <= float(got.min()) and float(got.max()) <= model.max_height
    assert float(got.std()) > 0.02 * (model.max_height - model.min_height)


@pytest.mark.parametrize("blend", [True, False], ids=["blend", "no_blend"])
def test_query_attachment_matches_jax_function(streamed, blend):
    """The planet's Rgba8 albedo (4 channels in [0, 1])."""
    terrain = streamed["planet"]
    cfg, jcfg, ju = _jax_inputs(terrain, blend)
    terrain._static_cfgs["cam"], saved = cfg, terrain._static_cfgs["cam"]
    try:
        pts = _points("planet", 3000, 22)
        got = terrain.query_attachment("cam", pts, 1)
    finally:
        terrain._static_cfgs["cam"] = saved
    att = terrain.atlas.attachments[1]
    want = np.asarray(jsampling.query_attachment(
        jnp.asarray(_slab(att)), ju, jcfg, jnp.asarray(pts.astype(np.float32)),
        att.config.scale, att.config.offset, att.config.format.max_value))
    assert got.shape == (3000, 4)
    err = float(np.abs(got.numpy() - want).max())
    print(f"planet blend={blend}: query_attachment max |port - JAX| {err:.3e}")
    assert err <= TOL_JAX["planet"][1]
    # the synthetic colour field: red never zero, alpha opaque
    assert float(got[:, 0].min()) > 0.1 and float(got[:, 3].min()) > 0.99


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_queries_match_host_sampling_api(streamed, scene):
    """Point by point against the f64 host chain (sampling_api.sample_height
    and, on the planet, sample_attachment of the albedo)."""
    terrain = streamed[scene]
    tree = terrain.tile_trees["cam"]
    pts = _points(scene, 64, 23)
    got = terrain.query_heights("cam", pts).numpy()
    want = np.array([sample_height(tree, terrain.atlas, p) for p in pts])
    err = float(np.abs(got - want).max())
    print(f"{scene}: query_heights max |port - host API| {err:.3e} m")
    assert err <= TOL_HOST[scene]
    assert np.abs(got).max() > 0.5  # real terrain, not zeros
    if scene == "planet":
        colors = terrain.query_attachment("cam", pts, 1).numpy()
        host = np.array([sample_attachment(tree, terrain.atlas, 1, p) for p in pts])
        cerr = float(np.abs(colors - host).max())
        print(f"{scene}: query_attachment max |port - host API| {cerr:.3e}")
        assert cerr <= 2.0 / 255.0


def test_frame_inputs_and_argument_checks(streamed):
    terrain = streamed["planar"]
    uniforms, cfg = terrain.frame_inputs("cam")
    assert cfg == terrain._static_cfgs["cam"]
    blob = terrain.last_uniform_blob("cam")
    want = unpack_frame_uniforms(_t(blob), cfg.side_count, cfg.lod_count, cfg.tree_size)
    for f in ("view_world_position", "entries", "origins", "world_from_local"):
        assert torch.equal(getattr(uniforms, f), getattr(want, f)), f
    with pytest.raises(ValueError):
        terrain.query_heights("cam", np.zeros((4, 2)))
    with pytest.raises(KeyError):
        terrain.frame_inputs("no such view")


# -- 3. tile_tree_lod frames ----------------------------------------------------------


def test_tile_tree_lod_patch_plan_matches_jax():
    """plan_patch_batch with the best-loaded walk instead of the blend lod:
    the sorted tiles and every PatchBatch field as the JAX package's, and a
    plan that differs from the blend-lod one."""
    blob, blocks, cfg, jcfg, plan, jplan = small_frame(tile_tree_lod=True,
                                                       blend_per_vertex=True)
    u = unpack_frame_uniforms(_t(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    tiles, batch = ps.plan_patch_batch(refinement.refine_tiles(u, cfg), u, cfg, plan,
                                       blocks.shape[0])
    jtiles, jbatch = jps.plan_patch_batch(jrefinement.refine_tiles(ju, jcfg), ju, jcfg, jplan,
                                          blocks.shape[0], 64)
    for f in ("tile_side", "tile_lod", "tile_xy", "tile_count"):
        np.testing.assert_array_equal(getattr(tiles, f).numpy(), np.asarray(getattr(jtiles, f)))
    for f in ("ids", "slots", "rank_lo", "rank_hi", "n_unique", "geom"):
        np.testing.assert_array_equal(getattr(batch, f).numpy(),
                                      np.asarray(getattr(jbatch, f)), err_msg=f)
    _, plain = ps.plan_patch_batch(
        refinement.refine_tiles(u, cfg), u, dataclasses.replace(cfg, tile_tree_lod=False),
        plan, blocks.shape[0])
    assert not torch.equal(plain.ids, batch.ids)


@pytest.mark.parametrize("view", ["data_lod", "pixels"])
def test_tile_tree_lod_debug_views_match_jax(view):
    """The data-lod and pixel views of a tile_tree_lod frame (the fused mesh
    of small_frame under that flag) in both packages."""
    blob, blocks, cfg, _, plan, _ = small_frame(tile_tree_lod=True)
    u = unpack_frame_uniforms(_t(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    raw, tiles = meshgen.generate_mesh_fused(refinement.refine_tiles(u, cfg), _t(blocks), u,
                                             cfg, plan, 65535.0)
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    ctx = mat.ShadeContext(mesh=mesh, tiles=tiles, normals=mesh.normals, uniforms=u, cfg=cfg)
    jctx = jmat.ShadeContext(mesh=_jax_mesh(mesh), tiles=_jax_tiles(tiles),
                             normals=jnp.asarray(mesh.normals.numpy()), uniforms=ju,
                             cfg=_jax_cfg(cfg))
    got = mat.DEBUG_VIEWS[view](ctx).numpy()
    want = np.asarray(jmat.DEBUG_VIEWS[view](jctx))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.std() > 0.0
