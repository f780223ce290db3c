"""The staged and per-vertex mesh stages and the staged attachment sampler:
the torch package against the JAX package.

``generate_mesh_grid`` runs in both packages on the same packed blob and
blocks: on ``small_frame`` (tests/test_torch_patch_sampling.py; planar, with
and without the Taylor path, at grid sizes 16 and 8, ``blend_per_vertex``
both ways) and on the small sphere frames of tests/test_torch_spherical_mesh.py
(with and without the Taylor path). The JAX function takes its XLA branch on
the CPU (``fetch_patches_xla`` + ``halfgrid_resample``, ``pallas_sampling``
off), the same math as its Pallas kernel, run once per frame under
``jax.jit`` (as the JAX pipeline runs it) and shared by the file's tests.
The port runs each frame twice against it: with ``pallas_sampling`` off
(its default on the CPU: ``fetch_patches`` + ``halfgrid_resample``, the JAX
branch's twin) and on (``kernels.fetch_resample_cached``, its plain version
here, at grid size 16; the staged functions at grid size 8). Per tile key,
within the tolerances of the fused tests: planar heights and positions 1e-3
m, uvs 1e-6 (test_torch_mesh_kernel.py); spherical :data:`JAX_TOL` of
test_torch_spherical_mesh.py.

The staged sampler (``sample_attachment_vertices`` with
``plan_matches_frame=False``, the path of a border-1 albedo beside a
border-2 height) is held to the JAX function within 1e-5 of full scale, on
one raw channel and on packed Rgba8 words.

The per-vertex stage (``generate_mesh``, ``sample_bilinear``) is held to the
JAX functions on ``small_frame`` with a random 16-slot uint16 height slab.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops import sampling as jsampling
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.ops import kernels, meshgen, refinement, sampling
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, unpack_frame_uniforms
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_spherical_mesh import FRAMES, JAX_TOL, small_sphere_frame, tile_rows

MAX_VALUE = 65535.0

# name -> (blob, blocks, port cfg, JAX cfg, plan, sides, lods)
PLANAR = {
    "planar": dict(blend_per_vertex=False),
    "planar_per_vertex": dict(blend_per_vertex=True),
    "planar_taylor": dict(blend_per_vertex=True, high_precision=True),
    "planar_grid8": dict(blend_per_vertex=False, grid_size=8),
    "planar_grid8_per_vertex": dict(blend_per_vertex=True, grid_size=8),
}
# the sphere without the Taylor path is what the pipeline's staged branch is
# for; with it, the staged path is the fused kernel's comparison
SPHERES = {
    "sphere": ("sphere", dict(high_precision=False, blend_per_vertex=True)),
    "sphere_taylor": ("sphere", dict(blend_per_vertex=True)),
    "sphere_near_taylor": ("sphere_near", dict(blend_per_vertex=False)),
}


def _frame(name):
    if name in PLANAR:
        blob, blocks, cfg, jcfg, plan, _ = small_frame()
        return (blob, blocks, dataclasses.replace(cfg, **PLANAR[name]),
                dataclasses.replace(jcfg, **PLANAR[name]), plan, 1, LODS)
    base, kw = SPHERES[name]
    blob, blocks, cfg, plan = small_sphere_frame(*FRAMES[base])
    cfg = {**cfg, **kw}
    return blob, blocks, StaticTerrainConfig(**cfg), JStaticConfig(**cfg), plan, 6, 4


@pytest.fixture(scope="module")
def jax_meshes():
    """name -> (JAX mesh, sorted tiles), each computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            blob, blocks, _, jcfg, plan, sides, lods = _frame(name)
            assert not jcfg.pallas_sampling  # the XLA branch

            @jax.jit
            def frame(blob, blocks):
                ju = junpack(blob, sides, lods, 8)
                return jmeshgen.generate_mesh_grid(jrefinement.refine_tiles(ju, jcfg), blocks,
                                                   ju, jcfg, plan, MAX_VALUE)

            cache[name] = frame(jnp.array(blob), jnp.array(blocks))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def meshes(jax_meshes):
    """(name, pallas_sampling) -> ((port mesh, sorted tiles, uniforms,
    cfg), (JAX mesh, sorted tiles)), each computed on first use."""
    cache = {}

    def get(name, switch=False):
        if (name, switch) not in cache:
            blob, blocks, cfg, _, plan, sides, lods = _frame(name)
            cfg = dataclasses.replace(cfg, pallas_sampling=switch)
            u = unpack_frame_uniforms(torch.from_numpy(blob), sides, lods, 8)
            calls = []
            k6 = kernels.fetch_resample_cached

            def spy(*args):
                calls.append(1)
                return k6(*args)

            before = k6.launches
            kernels.fetch_resample_cached = spy
            try:
                mesh, tiles = meshgen.generate_mesh_grid(
                    refinement.refine_tiles(u, cfg), torch.from_numpy(blocks), u, cfg, plan,
                    MAX_VALUE)
            finally:
                kernels.fetch_resample_cached = k6
            assert k6.launches == before  # a CPU call
            assert len(calls) == (switch and cfg.grid_size == 16)  # K6 by the switch
            cache[name, switch] = (mesh, tiles, u, cfg), jax_meshes(name)
        return cache[name, switch]

    return get


PATHS = {"ops": False, "k6": True}  # the pallas_sampling switch


def _per_key(meshes, name, tols, path="ops"):
    (mesh, tiles, u, cfg), (jmesh, jtiles) = meshes(name, PATHS[path])
    n = int(tiles.tile_count)
    assert n == int(jtiles.tile_count) > 6
    assert int(tiles.overflow) == int(jtiles.overflow)
    G1 = cfg.grid_size + 1
    assert mesh.heights.shape == (cfg.tile_capacity, G1, G1)
    rows = tile_rows(tiles, n)
    rows_j = tile_rows(jtiles, n)
    assert set(rows) == set(rows_j)
    view = u.view_world_position.numpy()
    worst = dict.fromkeys(tols, 0.0)
    for field, atol in tols.items():
        got = getattr(mesh, field).numpy()
        want = np.asarray(getattr(jmesh, field))
        if field == "positions":  # view-relative, as the spherical tests hold them
            got, want = got - view, want - view
        for key, i in rows.items():
            np.testing.assert_allclose(got[i], want[rows_j[key]], rtol=0, atol=atol,
                                       err_msg=f"{name} {field} {key}")
            worst[field] = max(worst[field], float(np.abs(got[i] - want[rows_j[key]]).max()))
        assert not got[n:].any() or field == "positions"
    print(f"{name} ({path}): max |port - JAX| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    np.testing.assert_array_equal(mesh.tile_mask.numpy(), np.asarray(jmesh.tile_mask))
    assert not mesh.positions[n:].any() and not mesh.heights[n:].any()
    h = mesh.heights[:n]
    assert float(h.max() - h.min()) > 10.0


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_grid_mesh_matches_jax(meshes, name, path):
    """Heights and positions within 1e-3 m, uvs within 1e-6, normals equal
    (the up vector)."""
    _per_key(meshes, name, dict(heights=1e-3, positions=1e-3, uvs=1e-6, normals=0.0), path)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name", sorted(SPHERES))
def test_spherical_grid_mesh_matches_jax(meshes, name, path):
    """Within test_torch_spherical_mesh.py's :data:`JAX_TOL` of the frame;
    unit normals within 1e-5."""
    h_tol, p_tol, uv_tol = JAX_TOL[SPHERES[name][0]]
    _per_key(meshes, name, dict(heights=h_tol, positions=p_tol, uvs=uv_tol, normals=1e-5),
             path)


def test_per_vertex_blend_differs_from_tile_centre_blend(meshes):
    """The two blends are different functions: the frame has tiles in a blend
    zone, where the per-vertex crossfade and the tile-centre one disagree."""
    a = meshes("planar")[0][0].heights
    b = meshes("planar_per_vertex")[0][0].heights
    assert float((a - b).abs().max()) > 1e-2


# -- the staged attachment sampler ----------------------------------------------


@pytest.mark.parametrize("form", ["raw", "rgba8"])
def test_staged_sampler_matches_jax(meshes, form):
    """An attachment whose plan is not the height's (512^2 with border 1
    beside border 2): per channel fetch_patches, halfgrid_resample and the
    3x3 window, against the JAX function within 1e-5 of full scale."""
    (mesh, tiles, u, cfg), (_, jtiles) = meshes("planar_per_vertex")
    blob = _frame("planar_per_vertex")[0]
    ju = junpack(jnp.array(blob), 1, LODS, 8)
    jcfg = JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    plan = ps.make_patch_plan(512, 4, 1)
    jplan = jps.make_patch_plan(512, 4, 1)
    assert tuple(plan) == tuple(jplan) and plan != ps.make_patch_plan(512, 4, 2)
    rng = np.random.default_rng(11)
    n_blocks = 16 * plan.total_blocks_per_slot
    if form == "raw":
        blocks = rng.integers(0, 65535, (n_blocks, 32, 128)).astype(np.int32)
        kw = dict(max_value=MAX_VALUE)
        channels = 1
    else:
        blocks = rng.integers(0, 1 << 32, (n_blocks, 32, 128), dtype=np.uint32).view(np.int32)
        kw = dict(max_value=255.0, packed_channels=4, packed_bits=8)
        channels = 4
    before = (kernels.attach_sample_fused.launches, kernels.attach_sample_fused_packed.launches)
    got = ps.sample_attachment_vertices(
        [torch.from_numpy(blocks)], tiles, mesh.uvs, u, cfg, plan, plan_matches_frame=False,
        **kw).numpy()
    assert before == (kernels.attach_sample_fused.launches,
                      kernels.attach_sample_fused_packed.launches)
    want = np.asarray(jax.jit(lambda blocks, uvs: jps.sample_attachment_vertices(
        [blocks], jtiles, uvs, ju, jcfg, jplan, plan_matches_frame=False, **kw))(
            jnp.array(blocks), jnp.array(mesh.uvs.numpy())))
    n = int(tiles.tile_count)
    assert got.shape == want.shape == (cfg.tile_capacity, 17, 17, channels)
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-5)
    assert 0.0 <= got[:n].min() and got[:n].max() <= 1.0 and got[:n].std() > 0.05


# -- the per-vertex stage -------------------------------------------------------


def test_sample_bilinear_matches_jax():
    """Random uint16 and uint8 slabs at random border-inset uvs, some outside
    [0, 1] (clamp to edge) and some invalid indices (zero)."""
    rng = np.random.default_rng(5)
    for dtype, channels, full in ((np.uint16, 1, 65535.0), (np.uint8, 4, 255.0)):
        slab = rng.integers(0, int(full) + 1, (6, 20, 20, channels)).astype(dtype)
        index = rng.integers(-1, 6, (50, 30)).astype(np.int32)
        uv = rng.uniform(-0.1, 1.1, (50, 30, 2)).astype(np.float32)
        got = sampling.sample_bilinear(torch.from_numpy(slab), torch.from_numpy(index),
                                       torch.from_numpy(uv), full).numpy()
        want = np.asarray(jsampling.sample_bilinear(jnp.array(slab), jnp.array(index),
                                                    jnp.array(uv), full))
        assert got.shape == want.shape == (50, 30, channels)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert not got[index < 0].any() and got[index >= 0].max() > 0.9
    np.testing.assert_array_equal(
        sampling.attachment_uv(torch.from_numpy(uv), 0.9375, 0.03125).numpy(),
        np.asarray(jsampling.attachment_uv(jnp.array(uv), 0.9375, 0.03125)))


@pytest.mark.parametrize("blend", [True, False], ids=["blend", "no_blend"])
def test_per_vertex_mesh_matches_jax(blend):
    """generate_mesh on small_frame with a random height slab of 32^2 tiles
    (border 1), in strip order: heights and positions within 1e-3 m, uvs
    within 1e-6, normals equal, dead tiles zero."""
    blob, _, cfg, jcfg, _, _ = small_frame(blend=blend)
    slab = np.random.default_rng(6).integers(0, 65536, (16, 32, 32, 1)).astype(np.uint16)
    scale, offset = 30.0 / 32.0, 1.0 / 32.0
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.array(blob), 1, LODS, 8)
    tiles = refinement.refine_tiles(u, cfg)
    mesh = meshgen.generate_mesh(tiles, torch.from_numpy(slab), u, cfg, scale, offset)
    jmesh = jax.jit(lambda ju, slab: jmeshgen.generate_mesh(
        jrefinement.refine_tiles(ju, jcfg), slab, ju, jcfg, scale, offset))(ju, jnp.array(slab))
    n = int(tiles.tile_count)
    V = cfg.vertices_per_tile
    assert n > 6 and mesh.heights.shape == (cfg.tile_capacity, V)
    for field, atol in (("heights", 1e-3), ("positions", 1e-3), ("uvs", 1e-6),
                        ("normals", 0.0)):
        np.testing.assert_allclose(getattr(mesh, field).numpy(),
                                   np.asarray(getattr(jmesh, field)), rtol=0, atol=atol,
                                   err_msg=field)
    np.testing.assert_array_equal(mesh.tile_mask.numpy(), np.asarray(jmesh.tile_mask))
    assert not mesh.positions[n:].any()
    assert float(mesh.heights[:n].std()) > 5.0
    # the strip order's uv table and the grid expansion
    np.testing.assert_array_equal(meshgen.vertex_grid_uv(cfg).numpy(),
                                  np.asarray(jmeshgen.vertex_grid_uv(jcfg)))
    grid = np.random.default_rng(7).uniform(0, 1, (3, 17, 17, 2)).astype(np.float32)
    np.testing.assert_array_equal(meshgen.grid_to_strip_order(torch.from_numpy(grid), cfg),
                                  jmeshgen.grid_to_strip_order(grid, jcfg))
