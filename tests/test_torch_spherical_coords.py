"""Spherical coordinate math, packed uniforms and refinement: the torch
package against the JAX package.

The same packed sphere frame goes to both packages. Then:

1. ``compute_local_position``, ``position_local_to_world``,
   ``normal_local_to_world``, ``compute_relative_position``,
   ``approximate_view_distance`` (on both sides of the precision threshold)
   and ``tile_visible`` agree on random (side, lod, xy, uv) lanes and on
   lanes near the view. Each is held to a stated bound in f32 ulps of the
   JAX value; ``tile_visible`` is exact;
2. the sphere blob packs bit for bit alike and unpacks exactly;
3. refinement gives the JAX package's buffers lane for lane, the committed
   ``nodes_sphere_approach`` golden exactly, and on random cameras a
   complete disjoint covering of all six sides (tests/test_ops.py fuzz).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.config import TerrainViewConfig as JViewConfig
from bevy_terrain_tpu.math import TerrainModel as JModel
from bevy_terrain_tpu.math import TerrainModelApproximation as JApprox
from bevy_terrain_tpu.math import frustum as jfrustum
from bevy_terrain_tpu.ops import coords as jcoords
from bevy_terrain_tpu.ops import params as jparams
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops import tile_tree as jtile_tree
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import Coordinate, TerrainModel, TerrainModelApproximation
from bevy_terrain_tpu_torch.math import frustum
from bevy_terrain_tpu_torch.ops import coords, params, refinement, tile_tree
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
R = 6.371e6
LODS = 13
ORIGIN_LOD = 10  # TerrainViewConfig's default


def _models(kind):
    """(port model, JAX model) of the same shape."""
    if kind == "sphere":
        args = (np.zeros(3), R, 0.0, 9000.0)
        return TerrainModel.sphere(*args), JModel.sphere(*args)
    # the WGS84-like semi-axes of models.earth_ellipsoid
    args = (np.zeros(3), 6_378_137.0, 6_356_752.3, 0.0, 9000.0)
    return TerrainModel.ellipsoid(*args), JModel.ellipsoid(*args)


def _view(model, altitude=3000.0):
    d = np.array([0.3, 0.2, 0.93])
    return model.position_local_to_world(d / np.linalg.norm(d), altitude)


def _blobs(kind, lods=LODS, seed=7, altitude=3000.0):
    """The sphere frame packed by each package from its own host modules:
    a culled camera looking at the planet's centre."""
    rng = np.random.default_rng(seed)
    entries = rng.integers(-1, 1024, (6, lods, 8, 8, 2)).astype(np.int32)
    out = []
    for model, Approx, ViewConfig, anchors, fr, pack in (
        (_models(kind)[1], JApprox, JViewConfig, jtile_tree.compute_view_anchors,
         jfrustum, jparams.pack_frame_uniforms),
        (_models(kind)[0], TerrainModelApproximation, TerrainViewConfig,
         tile_tree.compute_view_anchors, frustum, params.pack_frame_uniforms),
    ):
        view = _view(model, altitude)
        vc = ViewConfig(tile_capacity=2048)
        vp = fr.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
        origins, vt_int, vt_frac = anchors(model, view, lods, vc.tree_size)
        approx = Approx.compute(model, view, vc.origin_lod, 4500.0)
        out.append(pack(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                        view_proj=vp))
    return out


def _cfg(kind, lods=LODS, **kw):
    d = dict(spherical=True, side_count=6, lod_count=lods, tree_size=8, grid_size=16,
             refinement_count=TerrainViewConfig().refinement_count, queue_capacity=2048,
             tile_capacity=2048, origin_lod=ORIGIN_LOD, high_precision=True,
             ellipsoidal=kind == "ellipsoid")
    d.update(kw)
    return StaticTerrainConfig(**d), jparams.StaticTerrainConfig(**d)


def _both_uniforms(kind, altitude=3000.0):
    _, blob = _blobs(kind, altitude=altitude)
    return (params.unpack_frame_uniforms(torch.tensor(blob), 6, LODS, 8),
            jparams.unpack_frame_uniforms(jnp.array(blob), 6, LODS, 8))


def _lanes(kind, n=4096, seed=3):
    """Random (side, lod, xy, uv) lanes, half of them within a few tiles of
    the view's own coordinate, where the Taylor fallback takes over."""
    rng = np.random.default_rng(seed)
    model = _models(kind)[0]
    side = rng.integers(0, 6, n).astype(np.int32)
    lod = rng.integers(0, LODS, n).astype(np.int32)
    xy = (rng.random((n, 2)) * (1 << lod)[:, None]).astype(np.int32)
    uv = rng.random((n, 2)).astype(np.float32)
    c = Coordinate.from_world_position(_view(model), model)
    near = np.arange(n) % 2 == 0
    lod[near] = rng.integers(6, LODS, near.sum())
    side[near] = c.side
    count = (1 << lod[near])[:, None]
    base = np.floor(c.uv[None, :] * count).astype(np.int64)
    xy[near] = np.clip(base + rng.integers(-2, 3, (near.sum(), 2)), 0, count - 1)
    return side, lod, xy, uv


def _ulps(got, want):
    """|got - want| in f32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    spacing = np.spacing(np.abs(want).astype(np.float32))
    return np.abs(np.asarray(got, np.float64) - want) / spacing


def _lane_args(kind):
    # each package gets its own copy: neither aliases the other's memory
    lanes = _lanes(kind)
    return (tuple(torch.tensor(a) for a in lanes), tuple(jnp.array(a) for a in lanes))


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_pack_is_bit_identical(kind):
    jblob, tblob = _blobs(kind)
    assert jblob.dtype == tblob.dtype == np.int32
    np.testing.assert_array_equal(jblob, tblob)
    assert params.packed_f32_count(6, LODS) == jparams.packed_f32_count(6, LODS)


def _flat_fields(u, prefix=""):
    for f in dataclasses.fields(u):
        v = getattr(u, f.name)
        if dataclasses.is_dataclass(v):
            yield from _flat_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def test_unpack_fields_exact():
    tu, ju = _both_uniforms("sphere")
    jf, tf = dict(_flat_fields(ju)), dict(_flat_fields(tu))
    assert jf.keys() == tf.keys()
    for key, jv in jf.items():
        jv = np.asarray(jv)
        tv = tf[key].numpy()
        assert tv.dtype == jv.dtype and tv.shape == jv.shape, key
        np.testing.assert_array_equal(tv, jv, err_msg=key)


# Bounds, measured on 4096 lanes per model and stated with margin. XLA's
# CPU backend contracts the jitted norm's sum of squares into FMAs
# (fma(z, z, fma(y, y, x * x))) and torch's CPU f32 sqrt is not correctly
# rounded (MKL), so unit vectors differ by a few ulps; maps of the SAME
# input agree exactly (world) or to the norm's rounding (normals).
@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_local_world_normal(kind):
    (targs, jargs) = _lane_args(kind)
    tu, ju = _both_uniforms(kind)
    local = coords.compute_local_position(*targs, True)
    jlocal = jcoords.compute_local_position(*jargs, True)
    assert _ulps(local.numpy(), jlocal).max() <= 4  # measured 3
    same = torch.from_numpy(np.array(jlocal))
    world = coords.position_local_to_world(same, tu.world_from_local)
    jworld = jcoords.position_local_to_world(jlocal, ju.world_from_local)
    np.testing.assert_array_equal(world.numpy(), np.asarray(jworld))
    normal = coords.normal_local_to_world(same, tu.normal_matrix, True)
    jnormal = jcoords.normal_local_to_world(jlocal, ju.normal_matrix, True)
    # two ulps of a unit component (measured one)
    np.testing.assert_allclose(normal.numpy(), np.asarray(jnormal), rtol=0, atol=2.4e-7)
    planar = coords.compute_local_position(*targs, False)
    np.testing.assert_array_equal(planar.numpy(),
                                  np.asarray(jcoords.compute_local_position(*jargs, False)))


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_relative_position(kind):
    (targs, jargs) = _lane_args(kind)
    tu, ju = _both_uniforms(kind)
    got = coords.compute_relative_position(*targs, tu.taylor, ORIGIN_LOD).numpy()
    want = np.asarray(jcoords.compute_relative_position(*jargs, ju.taylor, ORIGIN_LOD))
    # the polynomial is the same sequence of f32 ops in both packages
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
@pytest.mark.parametrize("high_precision", [True, False])
def test_approximate_view_distance(kind, high_precision):
    (targs, jargs) = _lane_args(kind)
    tu, ju = _both_uniforms(kind)
    cfg, jcfg = _cfg(kind, high_precision=high_precision)
    got = coords.approximate_view_distance(*targs, tu, cfg).numpy().astype(np.float64)
    want = np.asarray(jcoords.approximate_view_distance(*jargs, ju, jcfg))
    threshold = float(tu.precision_threshold_distance)
    near = want < threshold
    assert near.sum() > 100 and (~near).sum() > 100  # both sides exercised
    err = np.abs(got - want)
    # a world-frame distance is a difference of near-equal ~6.4e6 m values
    # (one f32 ulp = 0.5 m): at most 6 ulps of those (measured 4, 2.0 m)
    ulp_world = float(np.spacing(np.float32(R)))
    assert err[~near].max() <= 6 * ulp_world, err[~near].max()
    if high_precision:
        # the Taylor fallback has no planet-scale operand: 4 ulps of the
        # threshold distance (measured 2)
        assert err[near].max() <= 4 * np.spacing(np.float32(threshold)), err[near].max()
    else:
        assert err[near].max() <= 6 * ulp_world, err[near].max()


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_tile_visible_exact(kind):
    (targs, jargs) = _lane_args(kind)
    tu, ju = _both_uniforms(kind)
    cfg, jcfg = _cfg(kind, culling=True)
    side, lod, xy, _ = targs
    jside, jlod, jxy, _ = jargs
    got = coords.tile_visible(side, lod, xy, tu, cfg).numpy()
    want = np.asarray(jcoords.tile_visible(jside, jlod, jxy, ju, jcfg))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_refine_matches_jax(kind):
    """The Earth frame (60 km, culled, 13 lods): buffers lane for lane."""
    tu, ju = _both_uniforms(kind, altitude=60_000.0)
    cfg, jcfg = _cfg(kind, culling=True)
    tiles = refinement.refine_tiles(tu, cfg)
    jtiles = jax.jit(jrefinement.refine_tiles, static_argnames="cfg")(ju, jcfg)
    for field in ("tile_side", "tile_lod", "tile_xy", "tile_count", "overflow"):
        np.testing.assert_array_equal(getattr(tiles, field).numpy(),
                                      np.asarray(getattr(jtiles, field)), err_msg=field)
    n = int(tiles.tile_count)
    assert n > 100 and int(tiles.overflow) == 0
    assert len(set(tiles.tile_side[:n].tolist())) > 1


def _port_model(model):
    return TerrainModel(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)})


def _refine_port(model, view, lods, capacity=32768):
    """The port's refinement of tests/test_ops.py::build_frame's frame
    (no hp, no culling, every entry the root tile)."""
    vc = TerrainViewConfig(tile_capacity=capacity)
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, lods, vc.tree_size)
    approx = TerrainModelApproximation.compute(
        model, view, vc.origin_lod, (model.min_height + model.max_height) / 2)
    entries = np.zeros((model.side_count, lods, vc.tree_size, vc.tree_size, 2), np.int32)
    blob = params.pack_frame_uniforms(model, view, approx, origins, entries, vt_int,
                                      vt_frac, vc)
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical, side_count=model.side_count, lod_count=lods,
        tree_size=vc.tree_size, grid_size=vc.grid_size,
        refinement_count=vc.refinement_count, queue_capacity=capacity,
        tile_capacity=capacity, origin_lod=vc.origin_lod,
    )
    u = params.unpack_frame_uniforms(torch.from_numpy(blob), model.side_count, lods,
                                     vc.tree_size)
    return refinement.refine_tiles(u, cfg)


def test_sphere_node_golden_exact():
    """tests/goldens/nodes_sphere_approach.npz, exactly."""
    from tools.make_goldens import node_selection_cases

    spec = {name: (m, v, l) for name, m, v, l in node_selection_cases()}
    jmodel, view, lods = spec["nodes_sphere_approach"]
    tiles = _refine_port(_port_model(jmodel), view, lods)
    n = int(tiles.tile_count)
    assert int(tiles.overflow) == 0
    nodes = torch.stack(
        [tiles.tile_side[:n], tiles.tile_lod[:n], tiles.tile_xy[:n, 0], tiles.tile_xy[:n, 1]],
        dim=-1,
    ).numpy()
    nodes = nodes[np.lexsort(nodes.T[::-1])]
    want = np.load(GOLDEN_DIR / "nodes_sphere_approach.npz")["nodes"]
    np.testing.assert_array_equal(nodes, want)


@pytest.mark.parametrize("trial", range(4))
def test_random_cameras_cover_the_sphere(trial):
    """The fuzz of tests/test_ops.py::TestRefinementFuzz on the port: a
    complete disjoint covering (area 1 per side), no overflow."""
    rng = np.random.default_rng(23 + trial)
    model = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
    u = rng.normal(size=3)
    pos = u / np.linalg.norm(u) * rng.uniform(6.45e6, 2.0e7)
    t = _refine_port(model, pos, 6)
    n = int(t.tile_count)
    assert int(t.overflow) == 0 and n > 0
    side, lod, xy = t.tile_side[:n].numpy(), t.tile_lod[:n].numpy(), t.tile_xy[:n].numpy()
    for s in range(6):
        area = np.sum(0.25 ** lod[side == s].astype(np.float64))
        assert area == pytest.approx(1.0, abs=1e-12), s
    keys = set(zip(side.tolist(), lod.tolist(), xy[:, 0].tolist(), xy[:, 1].tolist()))
    assert len(keys) == n
    for sd, l, x, y in keys:
        for al in range(l):
            sh = l - al
            assert (sd, al, x >> sh, y >> sh) not in keys
