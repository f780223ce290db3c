"""render/material.py and the material frame: the torch package against JAX.

1. Every function of ``render/material.py`` on identical numpy inputs (the
   small fused frame's mesh, random colours and lights) in both packages,
   with no kernel run: normals (planar and spherical TBN), PBR lighting
   with every light kind and a shadow hook, the example materials, the
   debug views, the wireframe overlay and ``shade``; within 1e-5.
2. The streamed material frame: a synthetic planar height + Rgba8 albedo
   dataset with the height's patch plan (3 lods of 512^2 tiles, a 16-slot
   atlas, capacity 128) streamed through ``Terrain.update`` in both
   packages on the same files. The port lights the albedo inside the mesh
   kernel (``mesh_fused_shaded``); the JAX package on the CPU takes its
   staged path (mesh, XLA sampler, ``shade``). Colours agree within 2/255
   (the fast albedo's bf16 yardstick, which also covers the fused-vs-staged
   height gap in the normals), 4-channel and opaque. The unlit albedo
   material is staged (the mesh kernel, then ``attach_sample_fused_packed``)
   and equals the port's ``sample_attachment_grid`` within 1e-6
   (test_material.py:430), which matches the JAX package's sampler within
   1e-5; a staged lit material (wireframe) equals ``render.material.shade``
   on that grid.
"""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu.ops.refinement import RefinementOutput as JRefinementOutput
from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
TOL_FAST = 2.0 / 255.0


def _jax_mesh(mesh):
    return jmeshgen.GridMeshOutput(**{f: jnp.asarray(getattr(mesh, f).numpy())
                                      for f in jmeshgen.GridMeshOutput._fields})


def _jax_tiles(tiles):
    return JRefinementOutput(**{f: jnp.asarray(getattr(tiles, f).numpy())
                                for f in JRefinementOutput._fields})


def _jax_cfg(cfg):
    return JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _lights(pkg, shadow):
    return (
        pkg.DirectionalLight(direction=(-0.3, -0.8, -0.5), color=(1.0, 0.9, 0.8),
                             illuminance=0.9, shadow=shadow),
        pkg.PointLight(position=(120.0, 300.0, -80.0), range=3000.0, intensity=0.5),
        pkg.SpotLight(position=(0.0, 200.0, 0.0), direction=(0.1, -1.0, 0.2), range=2000.0,
                      intensity=0.7, inner_angle=0.3, outer_angle=0.7),
    )


# -- 1. material functions on identical inputs --------------------------------


@pytest.fixture(scope="module")
def shading_inputs():
    """The small fused frame's mesh and tiles with random heights, in both
    packages (port tensors, JAX arrays), and the two ShadeContexts."""
    blob, blocks, cfg, _, plan, _ = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    raw, tiles = meshgen.generate_mesh_fused(refinement.refine_tiles(u, cfg),
                                             torch.from_numpy(blocks), u, cfg, plan, 65535.0)
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    jcfg = _jax_cfg(cfg)
    return dict(mesh=mesh, tiles=tiles, u=u, cfg=cfg, jmesh=_jax_mesh(mesh),
                jtiles=_jax_tiles(tiles), ju=ju, jcfg=jcfg)


def _contexts(s, attachment_samples=None):
    normals = mat.surface_normals_from_heights(s["mesh"], s["tiles"], s["u"], s["cfg"])
    jnormals = jmat.surface_normals_from_heights(s["jmesh"], s["jtiles"], s["ju"], s["jcfg"])
    ctx = mat.ShadeContext(mesh=s["mesh"], tiles=s["tiles"], normals=normals, uniforms=s["u"],
                           cfg=s["cfg"], attachment_samples=attachment_samples)
    jctx = jmat.ShadeContext(
        mesh=s["jmesh"], tiles=s["jtiles"], normals=jnormals, uniforms=s["ju"], cfg=s["jcfg"],
        attachment_samples=None if attachment_samples is None else {
            k: jnp.asarray(v.numpy()) for k, v in attachment_samples.items()})
    return ctx, jctx


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=what)


def test_planar_normals_match_jax(shading_inputs):
    ctx, jctx = _contexts(shading_inputs)
    _close(ctx.normals, jctx.normals)
    # the heights vary, so the normals tilt
    assert float(ctx.normals[..., 1].min()) < 0.999


def test_spherical_normals_match_jax(shading_inputs):
    """The per-face TBN of a sphere: random unit normals and heights on
    tiles of all six sides."""
    s = shading_inputs
    rng = np.random.default_rng(7)
    F = s["cfg"].tile_capacity
    normals = rng.normal(size=(F, 17, 17, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    heights = rng.uniform(0, 9000, (F, 17, 17)).astype(np.float32)
    mesh = dataclasses.replace(s["mesh"], normals=torch.from_numpy(normals),
                               heights=torch.from_numpy(heights))
    side = torch.from_numpy(rng.integers(0, 6, s["tiles"].tile_side.shape).astype(np.int32))
    tiles = dataclasses.replace(s["tiles"], tile_side=side)
    cfg = dataclasses.replace(s["cfg"], spherical=True, side_count=6)
    got = mat.surface_normals_from_heights(mesh, tiles, s["u"], cfg)
    want = jmat.surface_normals_from_heights(_jax_mesh(mesh), _jax_tiles(tiles), s["ju"],
                                             _jax_cfg(cfg))
    _close(got, want)


def test_pbr_lighting_matches_jax(shading_inputs):
    """Directional (with a shadow hook), point and spot lights, metallic,
    rough, emissive and ambient terms."""
    s = shading_inputs
    ctx, jctx = _contexts(s)
    rng = np.random.default_rng(8)
    colors = rng.uniform(0, 1, ctx.normals.shape[:-1] + (4,)).astype(np.float32)
    kw = dict(perceptual_roughness=0.6, metallic=0.2, reflectance=0.4,
              emissive=(0.01, 0.02, 0.03), ambient=(0.05, 0.04, 0.03))
    got = mat.pbr_lighting(torch.from_numpy(colors), ctx.normals, s["mesh"].positions,
                           s["u"].view_world_position,
                           lights=_lights(mat, lambda p: 0.5 + 0.5 * torch.sin(p[..., :1])),
                           **kw)
    want = jmat.pbr_lighting(jnp.asarray(colors), jctx.normals, s["jmesh"].positions,
                             s["ju"].view_world_position,
                             lights=_lights(jmat, lambda p: 0.5 + 0.5 * jnp.sin(p[..., :1])),
                             **kw)
    _close(got, want)
    assert float(got[..., :3].max()) > 0.1
    _close(mat.lambert_lighting(torch.from_numpy(colors), ctx.normals),
           jmat.lambert_lighting(jnp.asarray(colors), jctx.normals))


def test_materials_match_jax(shading_inputs):
    ctx, jctx = _contexts(shading_inputs)
    _close(mat.gradient_material()(ctx), jmat.gradient_material()(jctx))
    _close(mat.default_color(ctx), jmat.default_color(jctx))
    for pkg_ctx in ((mat, ctx), (jmat, jctx)):
        with pytest.raises(ValueError):  # no sampled attachment
            pkg_ctx[0].albedo_material(1)(pkg_ctx[1])
    samples = {1: torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, ctx.normals.shape[:-1] + (3,)).astype(np.float32))}
    ctx, jctx = _contexts(shading_inputs, samples)
    _close(mat.albedo_material(1)(ctx), jmat.albedo_material(1)(jctx))


@pytest.mark.parametrize("view", ["geometry_lod", "data_lod", "uv", "normals", "pixels"])
def test_debug_views_match_jax(shading_inputs, view):
    ctx, jctx = _contexts(shading_inputs)
    _close(mat.DEBUG_VIEWS[view](ctx), jmat.DEBUG_VIEWS[view](jctx), what=view)


def test_tile_tree_view_is_not_ported(shading_inputs):
    """The tile-tree view needs lookup_best (the best-loaded walk), which
    the port does not have yet: it raises instead of drawing another view."""
    ctx, _ = _contexts(shading_inputs)
    with pytest.raises(NotImplementedError):
        mat.show_tile_tree(ctx)


@pytest.mark.parametrize("case", ["standard", "default_lit", "unlit_wireframe", "debug_tuple"])
def test_shade_matches_jax(shading_inputs, case):
    s = shading_inputs
    kw = {
        "standard": lambda pkg: dict(material=pkg.StandardMaterial(
            base_color=pkg.gradient_material(), perceptual_roughness=0.5, metallic=0.1,
            lights=_lights(pkg, None))),
        "default_lit": lambda pkg: {},
        "unlit_wireframe": lambda pkg: dict(material=pkg.gradient_material(), lighting=False,
                                            wireframe=True),
        "debug_tuple": lambda pkg: dict(debug_view=("data_lod", "pixels")),
    }[case]
    got = mat.shade(s["mesh"], s["tiles"], s["u"], s["cfg"], **kw(mat))
    want = jmat.shade(s["jmesh"], s["jtiles"], s["ju"], s["jcfg"], **kw(jmat))
    _close(got, want, what=case)


# -- 2. the streamed material frame --------------------------------------------

VIEW = np.array([-120.0, 90.0, 160.0])
HEIGHT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
ALBEDO = dict(HEIGHT, name="albedo")
TERRAIN = dict(lod_count=3, atlas_size=16, path="terrains/material")
VIEW_CONFIG = dict(tile_capacity=128, morph_distance=4.0, blend_distance=1.5)
VIEW_KW = dict(queue_capacity=512, blend_per_vertex=True)


def _stream(terrain):
    """Update until no tile is loading, then return one more frame."""
    for _ in range(60):
        terrain.update({"cam": VIEW})
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    return terrain.update({"cam": VIEW})["cam"]


def _port_terrain(root):
    config = TerrainConfig(
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        attachments=(AttachmentConfig(**HEIGHT),
                     AttachmentConfig(**ALBEDO, format=AttachmentFormat.RGBA8)),
        assets_root=str(root), **TERRAIN,
    )
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(**VIEW_CONFIG), **VIEW_KW)
    return terrain


def _fused_material(pkg, opaque=False):
    return pkg.StandardMaterial(base_color=pkg.albedo_material(1), perceptual_roughness=0.6,
                                metallic=0.2, reflectance=0.4, lights=_lights(pkg, None),
                                opaque_base_color=opaque)


def _keyed(out, values):
    n = out.tile_count
    t = out.tiles
    keys = zip(t.tile_lod[:n].tolist(), t.tile_xy[:n, 0].tolist(), t.tile_xy[:n, 1].tolist())
    return {k: values[i] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_material")
    for att in (AttachmentConfig(**HEIGHT),
                AttachmentConfig(**ALBEDO, format=AttachmentFormat.RGBA8)):
        generate_planar_dataset(TERRAIN["path"], TERRAIN["lod_count"], att, root=str(root))
    return root


@pytest.fixture(scope="module")
def port_frames(dataset):
    """The port's frames after streaming to quiescence: lit in the kernel
    (4 channels, then opaque), then staged: the unlit albedo, and the lit
    albedo with the wireframe overlay."""
    terrain = _port_terrain(dataset)
    terrain.set_shading(_fused_material(mat), sample_attachments=(1,))
    frames = {"fused": _stream(terrain)}
    terrain.set_shading(_fused_material(mat, opaque=True), sample_attachments=(1,))
    frames["opaque"] = terrain.update({"cam": VIEW})["cam"]
    terrain.set_shading(mat.albedo_material(1), lighting=False, sample_attachments=(1,))
    frames["unlit"] = terrain.update({"cam": VIEW})["cam"]
    terrain.set_shading(_fused_material(mat), wireframe=True, sample_attachments=(1,))
    frames["staged"] = terrain.update({"cam": VIEW})["cam"]
    return terrain, frames


@pytest.fixture(scope="module")
def jax_frame(dataset):
    from bevy_terrain_tpu import AttachmentConfig as JAtt
    from bevy_terrain_tpu import AttachmentFormat as JFormat
    from bevy_terrain_tpu import Terrain as JTerrain
    from bevy_terrain_tpu import TerrainConfig as JConfig
    from bevy_terrain_tpu import TerrainModel as JModel
    from bevy_terrain_tpu import TerrainViewConfig as JViewConfig

    config = JConfig(
        model=JModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        attachments=(JAtt(**HEIGHT), JAtt(**ALBEDO, format=JFormat.RGBA8)),
        assets_root=str(dataset), **TERRAIN,
    )
    terrain = JTerrain(config)
    terrain.add_view("cam", JViewConfig(**VIEW_CONFIG), **VIEW_KW)
    terrain.set_shading(_fused_material(jmat), sample_attachments=(1,))
    return terrain, _stream(terrain)


def test_fused_path_is_taken(port_frames):
    """The lit albedo material runs in the mesh kernel (the colours ride
    the raw tensor); unlit or with a wireframe the material is staged."""
    terrain, frames = port_frames
    n = frames["fused"].tile_count
    assert n > 0
    assert frames["fused"].raw_mesh.shape[1] == 6 + 4
    assert frames["opaque"].raw_mesh.shape[1] == 6 + 3
    assert frames["unlit"].raw_mesh.shape[1] == 6
    assert frames["staged"].raw_mesh.shape[1] == 6
    for f in frames.values():
        assert f.colors.shape == (terrain.view_configs["cam"].tile_capacity, 17, 17, 4)
        assert torch.isfinite(f.colors).all()


def test_host_blob_matches_jax_terrain(port_frames, jax_frame):
    terrain, _ = port_frames
    np.testing.assert_array_equal(terrain.last_uniform_blob("cam"),
                                  np.asarray(jax_frame[0]._last_uniforms["cam"]))


@pytest.mark.parametrize("form", ["fused", "opaque"])
def test_fused_shade_matches_jax_terrain(port_frames, jax_frame, form):
    _, frames = port_frames
    out, jout = frames[form], jax_frame[1]
    assert out.tile_count == int(jout.tile_count)
    got = _keyed(out, out.colors.numpy())
    want = _keyed(jout, np.asarray(jout.colors))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL_FAST,
                                   err_msg=f"{form} {key}")


def test_opaque_rgb_equals_four_channel(port_frames):
    """Opaque skips the alpha channel only; the pad is the tile's liveness
    (the fixture's alpha is 255, which the 4-channel kernel resamples to 1
    within the bf16 path's rounding)."""
    _, frames = port_frames
    np.testing.assert_array_equal(frames["opaque"].colors[..., :3].numpy(),
                                  frames["fused"].colors[..., :3].numpy())
    np.testing.assert_allclose(frames["opaque"].colors[..., 3].numpy(),
                               frames["fused"].colors[..., 3].numpy(), rtol=0, atol=1e-6)


def test_unlit_colors_equal_attachment_grid(port_frames):
    """The unlit albedo material's colours are the sampler's values at the
    mesh's morphed uvs (the JAX pipeline's staged path)."""
    terrain, frames = port_frames
    out = frames["unlit"]
    grid = terrain.sample_attachment_grid("cam", out, 1)
    mask = out.mesh.tile_mask
    np.testing.assert_allclose(out.colors[mask].numpy(), grid[mask].numpy(), rtol=0, atol=1e-6)
    # the synthetic colour field: red rises along u from 0.1, alpha is 1
    assert float(grid[mask][..., 0].min()) >= 0.09 and float(grid[mask][..., 3].min()) > 0.99
    with pytest.raises(NotImplementedError):
        terrain.sample_attachment_grid("cam", out, 1, grad_taps=4)


def test_staged_colors_equal_material_shade(port_frames):
    terrain, frames = port_frames
    out = frames["staged"]
    cfg = terrain._static_cfgs["cam"]
    u = unpack_frame_uniforms(torch.from_numpy(terrain.last_uniform_blob("cam")),
                              cfg.side_count, cfg.lod_count, cfg.tree_size)
    want = mat.shade(out.mesh, out.tiles, u, cfg, material=_fused_material(mat),
                     wireframe=True,
                     attachment_samples={1: terrain.sample_attachment_grid("cam", out, 1)})
    np.testing.assert_allclose(out.colors.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_attachment_grid_matches_jax_sampler(port_frames):
    """sample_attachment_grid against the JAX package's sampler (its XLA
    fallback on the CPU) on the port's tiles, uvs and packed blocks."""
    terrain, frames = port_frames
    out = frames["unlit"]
    cfg = terrain._static_cfgs["cam"]
    albedo = terrain.atlas.attachments[1]
    got = terrain.sample_attachment_grid("cam", out, 1).numpy()
    ju = junpack(jnp.asarray(terrain.last_uniform_blob("cam")), cfg.side_count, cfg.lod_count,
                 cfg.tree_size)
    want = np.asarray(jps.sample_attachment_vertices(
        [jnp.asarray(albedo.block_array.numpy())], _jax_tiles(out.tiles),
        jnp.asarray(out.mesh.uvs.numpy()), ju, _jax_cfg(cfg), albedo.patch_plan, 255.0,
        packed_channels=4, packed_bits=8))
    n = out.tile_count
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=TOL)


def test_opaque_alpha_pad_masks_dead_capacity(port_frames):
    """The opaque alpha pad follows tile_count, not the buffer rows
    (test_fused_mesh.py:479-511): a truncated count leaves a dead tail."""
    terrain, frames = port_frames
    out = frames["opaque"]
    n = out.tile_count - 10
    cut = TerrainFrameOutput(
        dataclasses.replace(out.tiles, tile_count=torch.tensor(n, dtype=torch.int32)),
        out.raw_mesh, terrain._static_cfgs["cam"], out.mesh_inputs, shaded_channels=3)
    c = cut.colors.numpy()
    np.testing.assert_array_equal(c[:n, ..., 3], 1.0)
    np.testing.assert_array_equal(c[n:, ..., 3], 0.0)


def test_interop_carries_packed_jax_atlas(dataset, port_frames, jax_frame):
    """A fresh port Terrain filled from the JAX atlas (its packed Rgba8
    block array carried as numpy) renders the streamed port frame's colours
    bit for bit, with no tile loads."""
    _, frames = port_frames
    jatlas = jax_frame[0].atlas
    terrain = _port_terrain(dataset)
    interop.atlas_from_numpy(
        terrain.atlas,
        [[np.asarray(b) for b in a.block_arrays] for a in jatlas.attachments],
        [list(a.data) for a in jatlas.attachments],
        {(c.side, c.lod, c.x, c.y): (s.atlas_index, 0, s.loading_remaining)
         for c, s in jatlas.state.tile_states.items()},
    )
    terrain.set_shading(_fused_material(mat), sample_attachments=(1,))
    got = terrain.update({"cam": VIEW})["cam"]
    assert not terrain.atlas.state.to_load
    want = frames["fused"]
    assert got.tile_count == want.tile_count
    np.testing.assert_array_equal(got.colors.numpy(), want.colors.numpy())
