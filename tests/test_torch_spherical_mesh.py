"""Fused spherical mesh stage (kernel K2's plain version): the torch
package against the JAX package's fused Pallas kernel in interpret mode.

The frame is tests/test_fused_mesh.py::TestFusedSpherical's: an Earth-radius
sphere, 4 lods, capacity 128, ``origin_lod`` 2 (so the frame's tiles re-anchor
in both directions), the view at 20 km, random atlas entries and blocks.
Both packages get the same packed blob and blocks. Per tile key (a tile
list is a set), with the JAX package's own fused-vs-staged yardsticks
(test_fused_mesh.py:167-207):

* the tile set, the kernel's per-tile parameters and step flags: equal;
* the port's f32 plain version against its own arithmetic in float64:
  heights within 1e-1 m, view-relative positions within 3.0 m (one f32
  ulp at 6.4e6 m is 0.5 m), uvs within 1e-6, unit normals within 1e-5;
* the port against the JAX kernel: within those bounds on the 20 km frame
  but for heights, within twice them where the JAX kernel's own rounding
  reaches them (:data:`JAX_TOL` states each bound with the measured values),
  and much tighter in the Taylor near field.

The same sphere run with ``ellipsoidal=True`` (normals from the normal
matrix) agrees with the sphere's position / radius shortcut: normals within
1e-5, view-relative positions within 2.0 m. A true ellipsoid (the WGS84-like
semi-axes) is held to the JAX kernel like the sphere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import pallas_kernels as jpk
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation, frustum
from bevy_terrain_tpu_torch.ops import kernels, meshgen, patch_sampling, refinement, tile_tree
from bevy_terrain_tpu_torch.ops.params import (
    StaticTerrainConfig, pack_frame_uniforms, unpack_frame_uniforms,
)
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

R = 6.371e6
LODS = 4
MAX_VALUE = 65535.0


# name -> (model kind, view altitude m, near-field frame). "sphere" is
# TestFusedSpherical's frame: unculled, it overflows its 128 slots with lod-4
# tiles, all of them deeper than origin_lod 2 and beyond the precision
# threshold. The "_near" frames put the view at 3 km under a culled camera
# (2 m morph distance, 14 refinement levels, 256 slots, origin_lod 6): no
# overflow, lods 1-13 on both sides of the origin lod, and vertices inside
# the precision threshold (0.001 R = 6.4 km), where the Taylor near field
# takes over.
FRAMES = {"sphere": ("sphere", 20_000.0, False), "sphere_near": ("sphere", 3000.0, True),
          "ellipsoid_near": ("ellipsoid", 3000.0, True)}


def small_sphere_frame(kind="sphere", altitude=20_000.0, near=False):
    """(blob, blocks, cfg kwargs, plan) of one of :data:`FRAMES`."""
    if kind == "sphere":
        model = TerrainModel.sphere(np.zeros(3), R, 0.0, 9000.0)
    else:
        model = TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, 0.0, 9000.0)
    capacity, origin_lod = (256, 6) if near else (128, 2)
    vc = TerrainViewConfig(tile_capacity=capacity, origin_lod=origin_lod,
                           **({"morph_distance": 2.0} if near else {}))
    anchor = np.array([0.3, 0.2, 0.93])
    view = model.position_local_to_world(anchor / np.linalg.norm(anchor), altitude)
    vp = frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9) if near else None
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(model, view, LODS, 8)
    approx = TerrainModelApproximation.compute(model, view, origin_lod, 4500.0)
    rng = np.random.default_rng(2)
    entries = np.zeros((6, LODS, 8, 8, 2), np.int32)
    entries[..., 0] = rng.integers(0, 16, (6, LODS, 8, 8))
    entries[..., 1] = np.minimum(np.arange(LODS), 2)[None, :, None, None]
    blob = pack_frame_uniforms(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                               view_proj=vp)
    plan = patch_sampling.make_patch_plan(512, 4, 2)
    blocks = rng.integers(0, 65535, (16 * plan.total_blocks_per_slot, 32, 128)).astype(np.int32)
    cfg = dict(spherical=True, side_count=6, lod_count=LODS, tree_size=8, grid_size=16,
               refinement_count=14 if near else 6, queue_capacity=512,
               tile_capacity=capacity, origin_lod=origin_lod, high_precision=True,
               ellipsoidal=kind == "ellipsoid", culling=near)
    return blob, blocks, cfg, plan


def tile_rows(tiles, n):
    side = np.asarray(tiles.tile_side[:n])
    lod = np.asarray(tiles.tile_lod[:n])
    xy = np.asarray(tiles.tile_xy[:n])
    return {(int(s), int(l), int(x), int(y)): i
            for i, (s, l, (x, y)) in enumerate(zip(side, lod, xy))}


def _port(blob, blocks, cfg, plan):
    cfg = StaticTerrainConfig(**cfg)
    u = unpack_frame_uniforms(torch.from_numpy(blob), 6, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    stiles, batch, args = meshgen.fused_kernel_args(tiles, torch.from_numpy(blocks), u, cfg,
                                                    plan, MAX_VALUE)
    raw = kernels.mesh_fused_spherical(*args)
    return u, cfg, stiles, args, raw, meshgen.fused_to_grid(raw, stiles, cfg)


def _jax(blob, blocks, cfg, plan, monkeypatch):
    """The JAX fused kernel (interpret mode) and the operands it was given.
    JAX gets copies of the inputs: no buffer is shared with the port."""
    seen = {}
    inner = jpk.mesh_fused

    def recording(block_array, batch, tile_params, fs, hp_steps=None, **kw):
        seen.update(tile_params=np.asarray(tile_params), hp_steps=np.asarray(hp_steps))
        return inner(block_array, batch, tile_params, fs, hp_steps, **kw)

    monkeypatch.setattr(jpk, "mesh_fused", recording)
    jcfg = JStaticConfig(**cfg)
    ju = junpack(jnp.array(blob), 6, LODS, 8)
    jraw, jtiles = jmeshgen.generate_mesh_fused(
        jrefinement.refine_tiles(ju, jcfg), jnp.array(blocks), ju, jcfg, plan, MAX_VALUE,
        interpret=True,
    )
    jmesh = jax.block_until_ready(jmeshgen.fused_to_grid(jraw, jtiles, jcfg, ju))
    return ju, jtiles, jmesh, seen


@pytest.fixture(scope="module")
def frames(request):
    """Port and JAX products per model kind, computed once per module."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, spec in FRAMES.items():
            frame = small_sphere_frame(*spec)
            out[name] = (_port(*frame), _jax(*frame, mp))
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_tile_params_and_step_flags_equal(frames, kind):
    (_, cfg, stiles, args, _, _), (_, jtiles, _, seen) = frames[kind]
    n = int(stiles.tile_count)
    assert n == int(jtiles.tile_count) > 6
    assert int(stiles.overflow) == int(jtiles.overflow)
    assert set(tile_rows(stiles, n)) == set(tile_rows(jtiles, n))
    np.testing.assert_array_equal(args[3].numpy(), seen["tile_params"])
    np.testing.assert_array_equal(args[5].numpy(), seen["hp_steps"])
    if kind.endswith("_near"):
        # no overflow; both Taylor re-anchor directions (lods above and
        # below origin_lod); high-precision and plain live steps
        lods = stiles.tile_lod[:n]
        assert int(stiles.overflow) == 0
        assert bool((lods < cfg.origin_lod).any()) and bool((lods > cfg.origin_lod).any())
        assert set(args[5].tolist()) >= {1, 2}


def _exact(args):
    """The plain version's arithmetic in float64 on the same inputs: the
    referee both f32 evaluations are measured against."""
    a = list(args)
    for k in (2, 3, 4):  # geom, tile_params, fs
        a[k] = a[k].double()
    return kernels.mesh_fused_spherical_reference(*a)


def _grid(raw, n):
    return raw[:n, 0].numpy(), raw[:n, 1:4].permute(0, 2, 3, 1).numpy()


# uv tolerance by frame. At 20 km no vertex morphs partially and uvs agree
# to 1e-6 (the fused-vs-staged yardstick). At 3 km under a 2 m morph
# distance, world-frame vertices (beyond the Taylor threshold) sit in morph
# zones, where the planet-scale f32 cancellation in their view distance
# (~1e-4 relative) moves the morph ratio and the uv by up to ~2e-5
# (measured 1.8e-5 against JAX, 1.6e-5 against float64).
UV_TOL = {"sphere": 1e-6, "sphere_near": 3e-5, "ellipsoid_near": 3e-5}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_mesh_matches_exact_arithmetic(frames, kind):
    """The port's f32 plain version against its own arithmetic in float64,
    at the JAX package's fused-vs-staged yardsticks: heights 1e-1 m,
    view-relative positions 3.0 m, unit normals 1e-5 (measured 0.066 m,
    2.0 m, 3e-7)."""
    (_, _, stiles, args, raw, _), _ = frames[kind]
    n = int(stiles.tile_count)
    exact = _exact(args)
    h, p = _grid(raw, n)
    he, pe = _grid(exact, n)
    np.testing.assert_allclose(h, he, rtol=0, atol=1e-1)
    np.testing.assert_allclose(p, pe, rtol=0, atol=3.0)
    np.testing.assert_allclose(raw[:n, 4:6].numpy(), exact[:n, 4:6].numpy(), rtol=0,
                               atol=UV_TOL[kind])
    np.testing.assert_allclose(raw[:n, 6:9].numpy(), exact[:n, 6:9].numpy(), rtol=0, atol=1e-5)


# Port against the JAX kernel, by frame: (heights m, view-relative positions
# m, uvs). The JAX package's fused-vs-staged yardsticks are 1e-1 m, 3.0 m and
# 1e-6 (test_fused_mesh.py:172-177). The two packages round differently at
# planet scale (XLA's CPU backend contracts products into FMAs and has its
# own rsqrt): against the float64 arithmetic of the same inputs, the port
# lands within 0.057 / 1.27 m / 4.0e-7 on "sphere" and 0.066 / 2.0 m on the
# near frames, the JAX kernel within 0.086 / 1.09 m / 6.8e-7 and 0.117 /
# 3.6 m, over its own position yardstick (measured on these frames). Two
# evaluations each near the yardstick of the same arithmetic are within
# twice it of each other: measured port-vs-JAX 0.104 m / 1.5 m / 8.9e-7 on
# "sphere" and 0.108 m / 4.25 m / 1.8e-5 on the near frames. So heights get
# twice the yardstick, positions keep it on the 20 km frame and get twice
# it near the view, and uvs keep it at 20 km; near frames take UV_TOL.
JAX_TOL = {"sphere": (2e-1, 3.0, 1e-6), "sphere_near": (2e-1, 6.0, UV_TOL["sphere_near"]),
           "ellipsoid_near": (2e-1, 6.0, UV_TOL["ellipsoid_near"])}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_mesh_matches_jax_interpret(frames, kind):
    """Per tile key, against the JAX kernel in interpret mode, within
    :data:`JAX_TOL`; unit normals within 1e-5.

    Deep in the Taylor near field (within half the precision threshold, so
    both kernels take it whatever the vertex height), heights agree within
    2e-3 m (measured 1.2e-3) and uvs within 1e-6. Positions there agree
    within one f32 ulp of the view's coordinates (0.5 m at 6.4e6 m): the
    kernels output absolute world positions, view + Taylor offset, and that
    sum is rounded to the planet-scale grid (the float64 arithmetic sits
    up to 0.49 m from both).
    """
    (u, _, stiles, args, _, mesh), (ju, jtiles, jmesh, _) = frames[kind]
    n = int(stiles.tile_count)
    view = u.view_world_position.numpy()
    view_ulp = float(np.spacing(np.abs(view).max()))
    threshold = float(u.precision_threshold_distance)
    h_tol, p_tol, uv_tol = JAX_TOL[kind]
    rows_j = tile_rows(jtiles, n)
    got = {f: getattr(mesh, f).numpy() for f in ("heights", "positions", "uvs", "normals")}
    want = {f: np.asarray(getattr(jmesh, f)) for f in got}
    near_count = 0
    for key, i in tile_rows(stiles, n).items():
        j = rows_j[key]
        np.testing.assert_allclose(got["heights"][i], want["heights"][j], rtol=0, atol=h_tol,
                                   err_msg=str(key))
        np.testing.assert_allclose(got["uvs"][i], want["uvs"][j], rtol=0, atol=uv_tol,
                                   err_msg=str(key))
        np.testing.assert_allclose(got["positions"][i] - view, want["positions"][j] - view,
                                   rtol=0, atol=p_tol, err_msg=str(key))
        np.testing.assert_allclose(got["normals"][i], want["normals"][j], rtol=0, atol=1e-5,
                                   err_msg=str(key))
        near = np.linalg.norm(want["positions"][j] - view, axis=-1) < 0.5 * threshold
        near_count += int(near.sum())
        np.testing.assert_allclose(got["heights"][i][near], want["heights"][j][near],
                                   rtol=0, atol=2e-3, err_msg=str(key))
        np.testing.assert_allclose(got["uvs"][i][near], want["uvs"][j][near],
                                   rtol=0, atol=1e-6, err_msg=str(key))
        np.testing.assert_allclose(got["positions"][i][near], want["positions"][j][near],
                                   rtol=0, atol=view_ulp, err_msg=str(key))
    assert (near_count > 1000) == kind.endswith("_near"), near_count
    # capacity lanes past tile_count: zeros in the port. (The JAX kernel
    # zeroes dead steps but multiplies dead lanes of a live step by
    # live = 0, which leaves NaN where their leftover coordinates fall off
    # the cube face; consumers mask them by tile_count.)
    np.testing.assert_array_equal(got["positions"][n:], 0.0)
    np.testing.assert_array_equal(mesh.tile_mask.numpy(), np.asarray(jmesh.tile_mask))


def test_ellipsoidal_normals_match_sphere_shortcut(frames):
    """On a sphere, the normal-matrix path (ellipsoidal=True) and the
    position / radius shortcut agree to f32 rounding."""
    (_, cfg, stiles, args, raw, mesh), _ = frames["sphere"]
    n = int(stiles.tile_count)
    raw_nm = kernels.mesh_fused_spherical(*args[:-1], True)
    view = args[4][39:42].numpy()
    np.testing.assert_allclose(raw_nm[:n, 6:9].numpy(), raw[:n, 6:9].numpy(), rtol=0,
                               atol=1e-5)
    pos = raw[:n, 1:4].permute(0, 2, 3, 1).numpy() - view
    pos_nm = raw_nm[:n, 1:4].permute(0, 2, 3, 1).numpy() - view
    np.testing.assert_allclose(pos_nm, pos, rtol=0, atol=2.0)
    np.testing.assert_array_equal(raw_nm[:, :1].numpy(), raw[:, :1].numpy())


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_normals_are_unit(frames, kind):
    (_, _, stiles, _, _, mesh), _ = frames[kind]
    n = int(stiles.tile_count)
    norm = np.linalg.norm(mesh.normals[:n].numpy().astype(np.float64), axis=-1)
    np.testing.assert_allclose(norm, 1.0, rtol=0, atol=1e-5)


def test_raw_layout(frames):
    """raw is (Fp, 9, 17, 17); fused_to_grid is a view of its channels."""
    (_, cfg, stiles, _, raw, mesh), _ = frames["sphere"]
    assert raw.shape == (cfg.tile_capacity, 9, 17, 17)
    np.testing.assert_array_equal(raw[:, 0].numpy(), mesh.heights.numpy())
    np.testing.assert_array_equal(raw[:, 6:9].permute(0, 2, 3, 1).numpy(),
                                  mesh.normals.numpy())
    n = int(stiles.tile_count)
    uv = raw[:n, 4:6].numpy()
    grid = np.arange(17) / 16.0
    assert np.all(np.abs(uv[:, 0] - grid[None, None, :]) <= 1.0 / 16 + 1e-6)
    assert np.all(np.abs(uv[:, 1] - grid[None, :, None]) <= 1.0 / 16 + 1e-6)


def test_dead_tiles_are_zero(frames):
    """Tiles past tile_count come out zero, whatever their step flag."""
    (_, _, _, args, raw, _), _ = frames["sphere"]
    cut = kernels.mesh_fused_spherical(*args[:6], torch.tensor([5], dtype=torch.int32),
                                       *args[7:])
    np.testing.assert_array_equal(cut[:5].numpy(), raw[:5].numpy())
    assert not cut[5:].any()


def test_hp_flag_selects_the_near_field(frames):
    """Near-field vertices take the Taylor position only on steps flagged 2:
    with every step flagged 1 the kernel keeps the world-frame position,
    within the planet-scale f32 envelope of the Taylor one."""
    (_, _, stiles, args, raw, _), _ = frames["sphere_near"]
    n = int(stiles.tile_count)
    flat = torch.where(args[5] == 2, 1, args[5]).to(torch.int32)
    far = kernels.mesh_fused_spherical(*args[:5], flat, *args[6:])
    diff = (far[:n, 1:4] - raw[:n, 1:4]).abs()
    assert float(diff.max()) > 0.0
    assert float(diff.max()) <= 3.0


def test_wrapper_checks_arguments(frames):
    (_, _, _, args, _, _), _ = frames["sphere"]
    blocks, ids, geom, params, fs, hp, count, origin_lod, ell = args
    bad = [
        (blocks.float(), ids, geom, params, fs, hp, count, origin_lod, ell),
        (blocks, ids, geom, params[:, :4].contiguous(), fs, hp, count, origin_lod, ell),
        (blocks, ids, geom, params, fs, hp.long(), count, origin_lod, ell),
        (blocks, ids, geom, params, fs, hp[:1], count, origin_lod, ell),
        (blocks, ids, geom, params.t().contiguous().t(), fs, hp, count, origin_lod, ell),
        (blocks, ids[:100], geom[:100], params[:100], fs, hp, count, origin_lod, ell),
        (blocks, ids, geom, params, fs, hp, count, -1, ell),
    ]
    for a in bad:
        with pytest.raises(ValueError):
            kernels.mesh_fused_spherical(*a)
    # a CPU call runs the plain version and does not count as a launch
    before = kernels.mesh_fused_spherical.launches
    kernels.mesh_fused_spherical(*args)
    assert kernels.mesh_fused_spherical.launches == before
