"""render_view and Terrain.render_image: the torch package against the JAX
package's rasterizer on the port's frame products.

1. ``render_view`` in both packages on the port's CPU frame of a streamed
   synthetic planar terrain (2 lods of 512^2 R16 heights, 12-60 m, and an Rgba8
   albedo whose colour map is R = u, G = v, B = 0.25; 64 live tiles of 128)
   and of a synthetic planet (2 data lods of 256^2 heights under 6 geometry
   lods, culled, 600 km up; 140 tiles of 512), fed as numpy to the JAX
   function: per-pixel PBR with the default material and with a lit
   albedo, per-pixel deferred texturing (``sample_attachment_pixel``)
   unlit, vertex shading, a debug view. The triangle ids agree on at least
   99.9% of the pixels (all of them here), both counters exactly, and the
   images wherever the ids agree: unlit within 1e-5, lit within 1e-4
   (measured: at most 2.4e-7 in every mode; ``pytest -rP`` prints them).
2. ``Terrain.render_image`` on the port alone, tests/test_raster.py's
   checks: per-pixel albedo follows the colour map, pixel and vertex albedo
   agree, grazing pixels pick coarser mips, the planet disc has no holes
   (from 600 km, where it fills the view, and from three radii, where its
   limb shows); a per-vertex mesh is refused.
3. Wiring: the keyword arguments ``render_image`` hands ``render_view``
   (the default per-pixel texturing, the vertex-sampled attachments) equal
   the JAX ``render_image``'s for the same shading state.
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu.render import raster as jr
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel, frustum
from bevy_terrain_tpu_torch.ops import kernels, meshgen, sampling
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.render import raster as tr
from bevy_terrain_tpu_torch.render.pipeline import Terrain, TerrainFrameOutput
from bevy_terrain_tpu_torch.utils.synthetic import (
    generate_planar_dataset, generate_spherical_dataset,
)
from tests.test_torch_material import _jax_cfg, _jax_mesh, _jax_tiles
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

TOL = {"unlit": 1e-5, "lit": 1e-4}
R = 6.371e6
PLANAR_VIEW = np.array([0.0, 320.0, 1.0])
HEIGHT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)


def _colour_map(u, v):
    return np.stack([u, v, np.full_like(u, 0.25), np.ones_like(u)], -1)


def _hills(u, v):  # tests/test_raster.py's albedo terrain: 12-60 m
    return 0.3 + 0.2 * np.sin(6.28 * u) * np.cos(6.28 * v)


def _stream(terrain, view, view_proj=None, view_id="cam"):
    proj = None if view_proj is None else {view_id: view_proj}
    for i in range(100):
        terrain.update({view_id: view}, proj)
        if i > 3 and not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments):
            break
        time.sleep(0.01)
    return terrain.update({view_id: view}, proj)[view_id]


def _look_down(view, target=(0.0, 0.0, 0.0)):
    return frustum.view_projection(view, np.asarray(target), np.radians(60.0), 1.0, near=0.5)


@pytest.fixture(scope="module")
def planar(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_render_planar"))
    atts = (AttachmentConfig(**HEIGHT),
            AttachmentConfig(**{**HEIGHT, "name": "albedo"}, format=AttachmentFormat.RGBA8))
    generate_planar_dataset("raster", 2, atts[0], height_fn=_hills, root=root)
    generate_planar_dataset("raster", 2, atts[1], root=root, field_fn=_colour_map)
    config = TerrainConfig(lod_count=2, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 120.0),
                           atlas_size=32, path="raster", attachments=atts, assets_root=root)
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=128, morph_distance=4.0),
                     queue_capacity=2048)
    terrain.set_shading(mat.StandardMaterial(base_color=mat.albedo_material(1)),
                        sample_attachments=(1,))
    out = _stream(terrain, PLANAR_VIEW)
    assert out.tile_count == 64 and out.overflow == 0
    return terrain, out


def _planet_config(root):
    att = AttachmentConfig(name="height", texture_size=256, border_size=2, mip_level_count=3)
    generate_spherical_dataset("raster_planet", 2, att, root=root)
    return TerrainConfig(lod_count=6, model=TerrainModel.sphere(np.zeros(3), R, 0.0, 9000.0),
                         atlas_size=128, path="raster_planet", attachments=(att,),
                         assets_root=root)


def _planet_vp(view):
    return frustum.view_projection(view, view * 0.5, np.radians(60.0), 1.0, near=1e3)


@pytest.fixture(scope="module")
def planet(tmp_path_factory):
    terrain = Terrain(_planet_config(str(tmp_path_factory.mktemp("torch_render_planet"))),
                      device="cpu")
    # density matched to the capture resolution (morph_distance 4)
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=512, morph_distance=4.0),
                     queue_capacity=2048, culling=True)
    view = np.array([0.0, 0.0, R + 600e3])
    out = _stream(terrain, view, _planet_vp(view))
    assert out.tile_count == 140 and out.overflow == 0
    return terrain, view, out


# -- 1. render_view in both packages -------------------------------------------


def _pixel_attachment(att, to):
    return (tuple(to(s) for s in att.slabs), att.config.scale, att.config.offset,
            att.config.format.max_value, att.config.texture_size)


def _modes(pkg, terrain, out, to):
    """mode -> (render_view keywords, tolerance class)."""
    albedo = pkg.StandardMaterial(base_color=pkg.albedo_material(1))
    modes = {
        "pixel": (dict(), "lit"),
        "vertex": (dict(shade_mode="vertex"), "lit"),
        "debug": (dict(debug_view="geometry_lod"), "unlit"),
        "unlit": (dict(lighting=False), "unlit"),
    }
    if len(terrain.atlas.attachments) > 1:
        tex = _pixel_attachment(terrain.atlas.attachments[1], to)
        grid = to(terrain.sample_attachment_grid("cam", out, 1))
        modes.update({
            "pixel_albedo": (dict(material=albedo, pixel_attachment=tex), "lit"),
            "pixel_attachment": (dict(material=albedo, lighting=False, pixel_attachment=tex),
                                 "unlit"),
            "vertex": (dict(material=albedo, shade_mode="vertex",
                            attachment_samples={1: grid}), "lit"),
        })
    return modes


def _render_both(terrain, out, vp, size, knobs):
    uniforms, cfg = terrain.frame_inputs("cam")
    ju = junpack(jnp.asarray(terrain.last_uniform_blob("cam")), cfg.side_count, cfg.lod_count,
                 cfg.tree_size)
    jmesh, jtiles, jcfg = _jax_mesh(out.mesh), _jax_tiles(out.tiles), _jax_cfg(cfg)
    port = _modes(mat, terrain, out, lambda t: t)
    jax_ = _modes(jmat, terrain, out, lambda t: jnp.asarray(t.numpy()))
    for mode, (kw, tol) in port.items():
        img, r = tr.render_view(out.mesh, out.tiles, uniforms, cfg, vp, size, size, **kw,
                                **knobs)
        jimg, jraster = jr.render_view(jmesh, jtiles, ju, jcfg, jnp.asarray(vp, jnp.float32),
                                       size, size, **jax_[mode][0], **knobs)
        yield mode, tol, img, r, np.asarray(jimg), jraster


def _hold_to_jax(what, cases):
    for mode, tol, img, r, jimg, jraster in cases:
        assert img.shape == (r.tri_id.shape[0], r.tri_id.shape[1], 4)
        assert img.dtype == torch.float32 and bool(torch.isfinite(img).all())
        assert int(r.near_culled) == int(jraster.near_culled)
        assert int(r.bin_overflow) == int(jraster.bin_overflow) == 0
        same = r.tri_id.numpy() == np.asarray(jraster.tri_id)
        cov = r.covered.numpy()
        err = float(np.abs(img.numpy() - jimg)[same].max())
        print(f"{what} {mode}: ids equal on {same.mean():.5%} of pixels, coverage "
              f"{cov.mean():.4f}, max |port - JAX| {err:.2e} (tol {TOL[tol]:.0e})")
        assert same.mean() >= 0.999 and cov.mean() > 0.5
        assert err <= TOL[tol]
        assert (img.numpy()[~cov] == 0).all()


def test_planar_render_view_matches_jax(planar):
    terrain, out = planar
    _hold_to_jax("planar", _render_both(terrain, out, _look_down(PLANAR_VIEW), 128,
                                        dict(bin_px=16, bin_cap=256)))


def test_planet_render_view_matches_jax(planet):
    terrain, view, out = planet
    _hold_to_jax("planet", _render_both(terrain, out, _planet_vp(view), 160,
                                        dict(bin_px=16, bin_cap=512)))


# -- 2. Terrain.render_image ----------------------------------------------------


def test_per_pixel_albedo_follows_colour_map(planar):
    terrain, out = planar
    before = {k: getattr(kernels, k).launches for k in ("attach_sample_fused_packed",
                                                         "mesh_fused_shaded")}
    img, raster = terrain.render_image("cam", out, _look_down(PLANAR_VIEW), 160, 160,
                                       lighting=False, bin_px=16, bin_cap=256)
    assert before == {k: getattr(kernels, k).launches for k in before}  # CPU: no launch
    cov = raster.covered.numpy()
    assert cov.mean() > 0.9 and int(raster.bin_overflow) == 0
    img = img.numpy()
    pos = tr.interpolate(raster, out.mesh.positions).numpy()
    err_u = np.abs(img[..., 0] - (pos[..., 0] / 1000.0 + 0.5))[cov]
    err_v = np.abs(img[..., 1] - (pos[..., 2] / 1000.0 + 0.5))[cov]
    assert np.median(err_u) < 0.02 and np.median(err_v) < 0.02
    assert np.abs(img[..., 2] - 0.25)[cov].max() < 0.04


def test_pixel_and_vertex_albedo_agree(planar):
    terrain, out = planar
    vp = torch.from_numpy(_look_down(PLANAR_VIEW).astype(np.float32))  # a tensor works too
    img_px, r1 = terrain.render_image("cam", out, vp, 128, 128, lighting=False, bin_px=16,
                                      bin_cap=256)
    img_vx, r2 = terrain.render_image("cam", out, vp, 128, 128, lighting=False,
                                      pixel_texturing=False, bin_px=16, bin_cap=256)
    assert torch.equal(r1.tri_id, r2.tri_id)
    cov = r1.covered.numpy()
    d = np.abs(img_px.numpy() - img_vx.numpy())[cov]
    # per-pixel filtering against vertex bilinear: the same image up to
    # sub-vertex detail
    assert np.median(d) < 0.02


def test_grazing_pixels_pick_coarser_mips(planar):
    terrain, _ = planar
    eye = np.array([0.0, 40.0, 0.0])
    terrain.add_view("low", TerrainViewConfig(tile_capacity=512, morph_distance=4.0),
                     queue_capacity=2048)
    out = _stream(terrain, eye, view_id="low")
    assert out.overflow == 0
    vp = frustum.view_projection(eye, np.array([0.0, 20.0, 300.0]), np.radians(60.0), 1.0,
                                 near=0.5)
    raster = tr.rasterize_grid(out.mesh.positions, out.mesh.tile_mask, vp, 128, 128, bin_px=16,
                               bin_cap=512)
    _, ddx, ddy = tr.pixel_uv_and_grads(raster, out.mesh, vp, 128, 128)
    mip = sampling.mip_level_from_grad(ddx, ddy, 512).numpy()
    cov = raster.covered.numpy()
    rows = [r for r in range(0, 128, 8) if cov[r].mean() > 0.5]
    assert len(rows) > 4
    prof = [np.median(mip[r][cov[r]]) for r in rows]
    # rows toward the horizon (smaller r) see coarser mips
    assert prof[0] > prof[-1] + 1.0
    terrain.remove_view("low")


def _holes(cov):
    """Uncovered pixels with covered pixels above and below in the column."""
    above = np.zeros_like(cov)
    above[1:] = np.maximum.accumulate(cov, 0)[:-1]
    below = np.zeros_like(cov)
    below[:-1] = np.maximum.accumulate(cov[::-1], 0)[::-1][1:]
    return int((~cov & above & below).sum())


@pytest.mark.parametrize("distance", ["600km", "3R"])
def test_planet_disc_renders_hole_free(planet, distance):
    terrain, view, out = planet
    if distance == "3R":  # the whole disc in view: its limb shows
        view = np.array([0.0, 0.0, 3.0 * R])
        out = _stream(terrain, view, _planet_vp(view))
    img, raster = terrain.render_image("cam", out, _planet_vp(view), 192, 192, bin_px=16,
                                       bin_cap=512, background=(0, 0, 0, 0))
    cov = raster.covered.numpy()
    assert int(raster.bin_overflow) == 0 and out.overflow == 0
    assert _holes(cov) == 0
    if distance == "3R":  # the disc's share of the view: pi tan^2(19.5 deg) / (2 tan 30 deg)^2
        assert 0.25 < cov.mean() < 0.33 and not cov[0].any() and not cov[-1].any()
    else:
        assert cov.mean() > 0.5
    img = img.numpy()
    assert np.isfinite(img).all() and img[cov].max() <= 1.0 + 1e-5
    assert (img[~cov] == 0).all()


def test_per_vertex_mesh_is_refused(planar):
    """The rasterizer takes grid meshes (the fused and the staged path);
    the per-vertex path's strip-ordered MeshOutput is refused."""
    terrain, out = planar
    F = out.mesh.positions.shape[0]
    strip = meshgen.MeshOutput(positions=torch.zeros(F, 10, 3), normals=torch.zeros(F, 10, 3),
                               uvs=torch.zeros(F, 10, 2), heights=torch.zeros(F, 10),
                               tile_mask=out.mesh.tile_mask)
    frame = TerrainFrameOutput(out.tiles, None, terrain._static_cfgs["cam"], mesh=strip)
    with pytest.raises(TypeError):
        terrain.render_image("cam", frame, _look_down(PLANAR_VIEW), 32, 32)
    uniforms, cfg = terrain.frame_inputs("cam")
    with pytest.raises(TypeError):
        tr.render_view(strip, out.tiles, uniforms, cfg, _look_down(PLANAR_VIEW), 32, 32)


# -- 3. render_image's wiring against the JAX package's -------------------------


def _fake_terrain(pkg_mat, shading, grid_mesh):
    """A stand-in for a Terrain with two attachments beside the height and
    a shading state; ``sample_attachment_grid`` returns a marker."""
    material, opts = shading(pkg_mat)

    def att(i):
        return types.SimpleNamespace(slabs=[f"slab{i}"], config=types.SimpleNamespace(
            scale=0.5 + i, offset=0.1 * i, texture_size=256 * i,
            format=types.SimpleNamespace(max_value=255.0)))

    return types.SimpleNamespace(
        shading_fn=material, _shade_opts=opts, atlas=types.SimpleNamespace(
            attachments=[att(0), att(1), att(2)]),
        frame_inputs=lambda view_id: ("uniforms", "cfg"),
        sample_attachment_grid=lambda view_id, out, attachment_index: f"grid{attachment_index}",
    ), types.SimpleNamespace(mesh=grid_mesh, tiles="tiles")


SHADINGS = {
    "none": lambda m: (None, None),
    "lit_albedo": lambda m: (m.StandardMaterial(base_color=m.albedo_material(1)),
                             (True, None, 512, False, (1,))),
    "unlit_albedo": lambda m: (m.albedo_material(2), (False, None, 512, False, (2,))),
    "two_samples": lambda m: (m.StandardMaterial(base_color=m.albedo_material(1)),
                              (True, None, 512, False, (1, 2))),
    "debug": lambda m: (m.StandardMaterial(base_color=m.albedo_material(1)),
                        (True, "geometry_lod", 512, False, (1,))),
    "gradient": lambda m: (m.gradient_material(), (True, None, 512, False, ())),
}
CALLS = {"default": {}, "vertex_colours": dict(pixel_texturing=False),
         "texture_2": dict(pixel_texturing=2), "vertex_mode": dict(shade_mode="vertex"),
         "given_samples": dict(attachment_samples={1: "mine"})}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("shading", list(SHADINGS))
def test_render_image_wiring_matches_jax(monkeypatch, shading, call):
    from bevy_terrain_tpu.render.pipeline import Terrain as JTerrain

    seen = {}

    def capture(key):
        def render_view(mesh, tiles, uniforms, cfg, view_proj, width, height, **kw):
            kw["material"] = None if kw["material"] is None else type(kw["material"]).__name__
            seen[key] = kw
            return None, None
        return render_view

    monkeypatch.setattr(jr, "render_view", capture("jax"))
    monkeypatch.setattr(tr, "render_view", capture("port"))
    grid = meshgen.GridMeshOutput(*(torch.zeros(1) for _ in range(5)))
    fake, out = _fake_terrain(jmat, SHADINGS[shading], grid)
    JTerrain.render_image(fake, "cam", out, None, 8, 8, **CALLS[call])
    fake, out = _fake_terrain(mat, SHADINGS[shading], grid)
    Terrain.render_image(fake, "cam", out, None, 8, 8, **CALLS[call])
    assert seen["port"] == seen["jax"]
    if shading == "lit_albedo" and call == "default":
        assert seen["port"]["pixel_attachment"][0] == ("slab1",)
        assert "attachment_samples" not in seen["port"]
    if shading == "lit_albedo" and call == "vertex_colours":
        assert seen["port"]["attachment_samples"] == {1: "grid1"}
