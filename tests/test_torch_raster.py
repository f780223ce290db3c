"""render/raster.py: the torch package's rasterizer against the JAX package's.

1. ``rasterize_grid`` on six scenes (tests/torch_raster_cases.py: the flat
   tile, bumpy tiles, the two-tile seam, a grazing view, a camera crossing
   the near plane, a bin cap small enough to overflow), the same numpy
   inputs in both packages: ``near_culled`` and ``bin_overflow`` exactly
   equal; ``tri_id`` and ``covered`` equal wherever the numpy scanline
   oracle's winner is decisive (more than 1e-3 px inside an edge); depth and
   barycentrics within 1e-5 where the ids agree.
2. The pieces exactly equal: ``edge_coef``, ``raster_coverage_rule``,
   ``add_skirts`` (planar and spherical), ``_skirt_vertex_map``.
3. ``interpolate`` and ``pixel_uv_and_grads`` on the same raster in both
   packages within 1e-5, and the analytic uv gradients against finite
   differences (tests/test_raster.py:277-320).
4. The port alone: no crack inside a bumpy grid, and no pixel drawn twice
   or left out where single-triangle tiles share edges through pixel
   centres.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.render import raster as jr
from bevy_terrain_tpu_torch.render import raster as tr
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from torch_raster_cases import (
    VP_TOPDOWN, decisive, flat_tile, oracle_raster, raster_cases, screen_vp,
    single_triangle_tiles,
)

TOL = 1e-5
CASES = raster_cases()


def _port(pos, mask, vp, W, H, **knobs):
    return tr.rasterize_grid(torch.from_numpy(pos), torch.tensor(mask), vp, W, H, **knobs)


def _jax_raster(raster):
    return jr.RasterOutput(**{f: jnp.asarray(getattr(raster, f).numpy())
                              for f in jr.RasterOutput._fields})


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    pos, mask, vp, W, H, knobs = CASES[name]
    got = _port(pos, mask, vp, W, H, **knobs)
    want = jr.rasterize_grid(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(vp), W, H,
                             **knobs)
    return name, got, want, oracle_raster(pos, np.asarray(mask), vp, W, H)


def test_counters_match_jax(case):
    name, got, want, _ = case
    assert got.near_culled.dtype == got.bin_overflow.dtype == torch.int32
    assert got.near_culled.dim() == got.bin_overflow.dim() == 0
    assert int(got.near_culled) == int(want.near_culled)
    assert int(got.bin_overflow) == int(want.bin_overflow)
    if name == "near":
        assert int(got.near_culled) > 0
    if name == "overflow":
        assert int(got.bin_overflow) > 0
    else:
        assert int(got.bin_overflow) == 0


def test_decisive_pixels_match_jax(case):
    name, got, want, (o_tri, o_depth, o_margin) = case
    dec = decisive(o_tri, o_margin)
    assert dec.mean() > 0.95
    tri, jtri = got.tri_id.numpy(), np.asarray(want.tri_id)
    cov = got.covered.numpy()
    assert got.tri_id.dtype == got.vert_idx.dtype == torch.int32
    np.testing.assert_array_equal(tri[dec], jtri[dec])
    np.testing.assert_array_equal(cov[dec], np.asarray(want.covered)[dec])
    assert cov.any() and np.array_equal(cov, tri >= 0)
    if name != "overflow":  # the oracle has no bin caps
        np.testing.assert_array_equal(tri[dec], o_tri[dec])
        covd = dec & (o_tri >= 0)
        np.testing.assert_allclose(got.depth.numpy()[covd], o_depth[covd], rtol=0, atol=TOL)
    same = tri == jtri
    print(f"{name}: ids equal on {same.mean():.4%} of pixels, decisive {dec.mean():.4%}")


def test_depth_and_barycentrics_match_jax(case):
    _, got, want, _ = case
    same = got.tri_id.numpy() == np.asarray(want.tri_id)
    np.testing.assert_allclose(got.depth.numpy()[same], np.asarray(want.depth)[same],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.bary.numpy()[same], np.asarray(want.bary)[same],
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.vert_idx.numpy()[same], np.asarray(want.vert_idx)[same])
    cov = got.covered.numpy()
    assert (got.depth.numpy()[~cov] == 0).all() and (got.bary.numpy()[~cov] == 0).all()
    np.testing.assert_allclose(got.bary.numpy()[cov].sum(-1), 1.0, rtol=0, atol=TOL)


def test_absurd_key_width_sorts_alike():
    """The lexicographic three-key branch (beyond 24 key or 31 id bits)
    orders the pairs as the packed key does."""
    rng = np.random.default_rng(4)
    T, nkeys = 500, 40
    key = torch.from_numpy(rng.integers(0, nkeys + 1, (T, 4)).astype(np.int32))
    znear = torch.from_numpy(-rng.integers(0, 2**30, (T, 1)).astype(np.int32)).expand(T, 4)
    packed = tr._sort_pairs(key, znear, T, nkeys)
    exact = tr._sort_pairs(key, znear, T, 2**25)
    real = packed[0] < nkeys
    assert torch.equal(packed[0], exact[0])
    assert torch.equal(packed[1][real], exact[1][real])


# -- 2. the pieces, exactly ----------------------------------------------------


def test_edge_coef_and_fill_rule_equal_jax():
    rng = np.random.default_rng(3)
    # snapped coordinates with many ties (x0 == x1, y0 == y1)
    pts = (rng.integers(0, 64, (4, 4096)) / 4.0 + rng.integers(0, 3, (4, 4096)) / 256.0)
    pts = pts.astype(np.float32)
    pts[2, ::3] = pts[0, ::3]
    pts[3, ::5] = pts[1, ::5]
    got = tr.edge_coef(*map(torch.from_numpy, pts))
    want = jr.edge_coef(*map(jnp.asarray, pts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # opposite endpoints give exact negations (the watertightness contract)
    back = tr.edge_coef(*map(torch.from_numpy, pts[[2, 3, 0, 1]]))
    for g, b in zip(got, back):
        np.testing.assert_array_equal(g.numpy(), -b.numpy())
    e = rng.integers(-2, 3, 4096).astype(np.float32)
    tl = rng.random(4096) < 0.5
    np.testing.assert_array_equal(
        tr.raster_coverage_rule(torch.from_numpy(e), torch.from_numpy(tl)).numpy(),
        np.asarray(jr.raster_coverage_rule(jnp.asarray(e), jnp.asarray(tl))))


@pytest.mark.parametrize("spherical", [False, True], ids=["planar", "spherical"])
def test_add_skirts_equal_jax(spherical):
    rng = np.random.default_rng(9)
    if spherical:
        d = rng.normal(size=(6, 17, 17, 3))
        pos = (6.371e6 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    else:
        pos = np.concatenate([flat_tile(G1=17, size=s) for s in (10.0, 40.0, 250.0)])
        pos[..., 1] += rng.uniform(0, 30, pos[..., 1].shape).astype(np.float32)
    got = tr.add_skirts(torch.from_numpy(pos), spherical=spherical).numpy()
    want = np.asarray(jr.add_skirts(jnp.asarray(pos), spherical=spherical))
    assert got.shape == (pos.shape[0], 19, 19, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 1:-1, 1:-1], pos)
    np.testing.assert_array_equal(tr._skirt_vertex_map(6, 17), jr._skirt_vertex_map(6, 17))
    np.testing.assert_array_equal(tr._triangle_vertex_indices(3, 5, 4),
                                  jr._triangle_vertex_indices(3, 5, 4))


# -- 3. interpolation and the analytic uv gradients ---------------------------


class _Mesh:
    def __init__(self, positions, uvs):
        self.positions, self.uvs = positions, uvs


@pytest.fixture(scope="module")
def uv_scene():
    """A bumpy 20 m tile at an oblique view, its uvs the tile grid."""
    G1 = 5
    pos = flat_tile(G1=G1, size=20.0)
    pos[..., 1] += np.random.default_rng(5).uniform(0, 4.0, pos[..., 1].shape).astype(np.float32)
    g = np.linspace(0.0, 1.0, G1, dtype=np.float32)
    uv = np.stack(np.broadcast_arrays(g[None, :], g[:, None]), -1)[None].astype(np.float32)
    from bevy_terrain_tpu_torch.math.frustum import view_projection

    vp = view_projection(eye=[6.0, 14.0, -18.0], target=[0.0, 0.0, 0.0],
                         fov_y=np.radians(55.0), aspect=1.0, near=0.1).astype(np.float32)
    raster = _port(pos, [True], vp, 96, 96, bin_px=16, bin_cap=64)
    return pos, uv, vp, raster


def test_interpolate_matches_jax(uv_scene):
    pos, uv, _, raster = uv_scene
    jraster = _jax_raster(raster)
    for values in (pos[..., 1], pos, uv):
        got = tr.interpolate(raster, torch.from_numpy(values), background=-1.0).numpy()
        want = np.asarray(jr.interpolate(jraster, jnp.asarray(values), background=-1.0))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pixel_uv_and_grads_match_jax(uv_scene):
    pos, uv, vp, raster = uv_scene
    got = tr.pixel_uv_and_grads(raster, _Mesh(torch.from_numpy(pos), torch.from_numpy(uv)), vp,
                                96, 96)
    want = jr.pixel_uv_and_grads(_jax_raster(raster), _Mesh(jnp.asarray(pos), jnp.asarray(uv)),
                                 jnp.asarray(vp), 96, 96)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_analytic_uv_gradients_match_finite_differences(uv_scene):
    pos, uv, vp, raster = uv_scene
    uvp, ddx, ddy = (t.numpy() for t in tr.pixel_uv_and_grads(
        raster, _Mesh(torch.from_numpy(pos), torch.from_numpy(uv)), vp, 96, 96))
    tri, cov = raster.tri_id.numpy(), raster.covered.numpy()
    # where the pixel and its +x (+y) neighbour share a triangle
    same = cov[:, :-1] & cov[:, 1:] & (tri[:, :-1] == tri[:, 1:])
    fd = uvp[:, 1:] - uvp[:, :-1]
    err = np.abs(fd - 0.5 * (ddx[:, 1:] + ddx[:, :-1]))[same]
    assert same.sum() > 1000 and np.median(err) < 0.02 * np.abs(fd[same]).mean() + 1e-6
    samev = cov[:-1, :] & cov[1:, :] & (tri[:-1, :] == tri[1:, :])
    fdy = uvp[1:, :] - uvp[:-1, :]
    erry = np.abs(fdy - 0.5 * (ddy[1:, :] + ddy[:-1, :]))[samev]
    assert np.median(erry) < 0.02 * np.abs(fdy[samev]).mean() + 1e-6


# -- 4. watertightness, on the port alone --------------------------------------


def test_no_cracks_inside_projected_grid():
    """A bumpy tile seen from above covers the analytic square with no
    hole along its internal edges (tests/test_raster.py's crack test)."""
    pos, mask, vp, W, H, knobs = CASES["bumpy"]
    cov = _port(pos, mask, vp, W, H, **knobs).covered.numpy()
    half = 20.0 * np.tan(np.radians(30.0))
    px_per_world = W / (2 * half)
    centers = (np.arange(W) + 0.5) / px_per_world - half
    d = np.minimum(np.abs(np.abs(centers) - 5.0)[None, :], np.abs(np.abs(centers) - 5.0)[:, None])
    inside = (np.abs(centers)[None, :] <= 5.0) & (np.abs(centers)[:, None] <= 5.0)
    interior = inside & (d > 2.0 / px_per_world)
    assert interior.sum() > 1000 and cov[interior].all()


@pytest.mark.parametrize("seed", [0, 1])
def test_shared_edges_draw_each_pixel_once(seed):
    """Triangles sharing edges through pixel centres, each alone in a tile:
    rendered one at a time, every pixel centre strictly inside the
    rectangle they tile is drawn by exactly one, none by two, and the
    render of all of them covers exactly the union, each pixel by the
    triangle that drew it alone."""
    W = H = 64
    pos, (x0, y0, x1, y1) = single_triangle_tiles(seed)
    vp = screen_vp(W, H)
    n = pos.shape[0]
    count = np.zeros((H, W), np.int64)
    owner = np.full((H, W), -1, np.int64)
    for f in range(n):
        mask = [i == f for i in range(n)]
        cov = _port(pos, mask, vp, W, H, bin_px=16, bin_cap=32).covered.numpy()
        count += cov
        owner[cov] = f
    assert count.max() == 1, "a pixel drawn by two triangles"
    c = np.arange(W) + 0.5
    strictly = ((c[None, :] > x0) & (c[None, :] < x1) & (c[:, None] > y0) & (c[:, None] < y1))
    assert count[strictly].min() == 1, "a crack between triangles"
    whole = _port(pos, [True] * n, vp, W, H, bin_px=16, bin_cap=32)
    np.testing.assert_array_equal(whole.covered.numpy(), count == 1)
    tiles_of = np.where(whole.covered.numpy(), whole.tri_id.numpy() // 2, -1)
    np.testing.assert_array_equal(tiles_of, owner)
