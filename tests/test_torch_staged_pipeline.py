"""The staged, fallback-sampler and per-vertex frames end to end: the torch
package's ``Terrain`` on the CPU against the JAX package's, on the same
files, at two cameras each (streamed to quiescence, then one more frame).

Both packages take their default path on the CPU (``pallas_sampling``
off), so each case compares like with like.

1. **Staged mesh**: a synthetic six-side planet (3 data lods of 256^2 tiles
   under 6 geometry lods, capacity 512) with ``add_view(...,
   high_precision=False)``: a sphere without the Taylor path, which both
   pipelines send through ``generate_mesh_grid``. The half-grid comes from
   the port's torch ops (``fetch_patches``, ``halfgrid_resample``) and from
   the JAX package's XLA branch; K6's plain version is held to the JAX
   kernel by test_torch_halfgrid*.py. The same blob; per tile key heights
   within 1e-2 m (measured 1.95e-3: two f32 ulps of the 9 km range),
   view-relative positions within 2.0 m (measured 1.5 m: three f32 ulps of
   the world position at the planet's radius, which this path keeps in
   f32), uvs within 1e-6, normals within 1e-5.
2. **Fallback sampler**: a planar terrain whose Rgba8 albedo has border 1
   beside the height's border 2 (examples/planar.py's layout), shaded by
   ``set_shading``: the staged mesh in both packages (heights and positions
   within 2e-4 m, measured 6.1e-5; uvs within 1e-6); unlit, the colours are
   the staged sampler's values and agree within 1e-5; lit by a
   StandardMaterial within 1e-5 (measured 1.9e-6).
3. **Per vertex**: a planar terrain whose 32^2 height tiles are too small
   for the patch plan: ``generate_mesh`` on the mip-0 slab in both
   packages. Heights and positions within 1e-3 m, uvs within 1e-6.
"""

import time

import numpy as np
import pytest
import torch

from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel, frustum
from bevy_terrain_tpu_torch.ops import kernels, meshgen
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.render.pipeline import Terrain
from bevy_terrain_tpu_torch.utils.synthetic import (
    generate_planar_dataset, generate_spherical_dataset,
)
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

R = 6.371e6


def _stream(terrain, view, view_proj=None):
    """Update until no tile is loading, then return one more frame."""
    proj = None if view_proj is None else {"cam": view_proj}
    for _ in range(60):
        terrain.update({"cam": view}, proj)
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    return terrain.update({"cam": view}, proj)["cam"]


def _terrains(root, model, attachments, terrain_kw, view_config, view_kw, port_kw=None):
    """(port Terrain on the CPU, JAX Terrain) over the same files.
    ``model`` is (constructor name, arguments); ``attachments`` a list of
    AttachmentConfig keyword dicts whose ``format`` is the enum's name;
    ``port_kw``: static overrides of the port's view alone (e.g.
    ``pallas_sampling=True``: the kernels' plain versions)."""
    import bevy_terrain_tpu as jbt

    def build(pkg_att, pkg_format, pkg_model, pkg_config, pkg_view, make, kw):
        atts = tuple(pkg_att(**{**a, "format": getattr(pkg_format, a.get("format", "R16"))})
                     for a in attachments)
        config = pkg_config(model=getattr(pkg_model, model[0])(*model[1]), attachments=atts,
                            assets_root=str(root), **terrain_kw)
        terrain = make(config)
        terrain.add_view("cam", pkg_view(**view_config), **kw)
        return terrain

    port = build(AttachmentConfig, AttachmentFormat, TerrainModel, TerrainConfig,
                 TerrainViewConfig, lambda c: Terrain(c, device="cpu"),
                 {**view_kw, **(port_kw or {})})
    jax_t = build(jbt.AttachmentConfig, jbt.AttachmentFormat, jbt.TerrainModel,
                  jbt.TerrainConfig, jbt.TerrainViewConfig, jbt.Terrain, view_kw)
    return port, jax_t


def _rows(tiles, n):
    side = np.asarray(tiles.tile_side[:n])
    lod = np.asarray(tiles.tile_lod[:n])
    xy = np.asarray(tiles.tile_xy[:n])
    return {(int(s), int(l), int(x), int(y)): i
            for i, (s, l, (x, y)) in enumerate(zip(side, lod, xy))}


def _assert_same_frame(out, jout, fields, view=None):
    """Per tile key, ``fields`` (name -> tolerance) of the two meshes."""
    n = out.tile_count
    assert n == int(jout.tile_count) > 6 and out.overflow == int(jout.overflow)
    rows, rows_j = _rows(out.tiles, n), _rows(jout.tiles, n)
    assert set(rows) == set(rows_j)
    worst = {}
    for field, atol in fields.items():
        got = getattr(out.mesh, field).numpy()
        want = np.asarray(getattr(jout.mesh, field))
        assert got.shape == want.shape, field
        if field == "positions" and view is not None:
            got, want = got - view, want - view
        i = np.array(list(rows.values()))
        j = np.array([rows_j[k] for k in rows])
        np.testing.assert_allclose(got[i], want[j], rtol=0, atol=atol, err_msg=field)
        worst[field] = float(np.abs(got[i] - want[j]).max())
        assert np.isfinite(got).all()
    print("max |port - JAX| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return rows, rows_j


# -- 1. the staged mesh ----------------------------------------------------------

SPH_ATT = dict(name="height", texture_size=256, border_size=2, mip_level_count=3)
SPH_TERRAIN = dict(lod_count=6, atlas_size=128, path="staged_sphere")
SPH_VIEWS = (np.array([0.0, 0.0, R + 60_000.0]),
             TerrainModel.sphere(np.zeros(3), R, 0.0, 9000.0).position_local_to_world(
                 np.array([0.3, 0.2, 0.93]) / np.linalg.norm([0.3, 0.2, 0.93]), 150_000.0))


@pytest.fixture(scope="module")
def staged_terrains(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_staged_sphere")
    generate_spherical_dataset(SPH_TERRAIN["path"], 3, AttachmentConfig(**SPH_ATT),
                               root=str(root))
    return _terrains(root, ("sphere", (np.zeros(3), R, 0.0, 9000.0)), [SPH_ATT], SPH_TERRAIN,
                     dict(tile_capacity=512),
                     dict(queue_capacity=1024, culling=True, high_precision=False))


@pytest.mark.parametrize("cam", [0, 1])
def test_staged_sphere_matches_jax_terrain(staged_terrains, cam):
    port, jax_t = staged_terrains
    cfg = port._static_cfgs["cam"]
    assert cfg.spherical and not cfg.high_precision and not port.use_fused(cfg)
    view = SPH_VIEWS[cam]
    proj = frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    before = {k: getattr(kernels, k).launches
              for k in ("fetch_resample_cached", "mesh_fused_spherical")}
    out = _stream(port, view, proj)
    jout = _stream(jax_t, view, proj)
    assert before == {k: getattr(kernels, k).launches for k in before}  # CPU: no launch
    np.testing.assert_array_equal(port.last_uniform_blob("cam"),
                                  np.asarray(jax_t._last_uniforms["cam"]))
    # the staged step hands over a ready grid mesh and no raw tensor
    assert out.raw_mesh is None and isinstance(out.mesh, meshgen.GridMeshOutput)
    assert out.colors is None and out.mesh_inputs == ()
    _assert_same_frame(out, jout, dict(heights=1e-2, positions=2.0, uvs=1e-6, normals=1e-5),
                       view)
    n = out.tile_count
    h = out.mesh.heights[:n]
    model = port.config.model
    assert model.min_height <= float(h.min()) and float(h.max()) <= model.max_height
    assert float(h.max() - h.min()) > 1000.0
    norm = torch.linalg.vector_norm(out.mesh.normals[:n].double(), dim=-1)
    assert float((norm - 1.0).abs().max()) <= 1e-5


# -- 2. the fallback sampler -----------------------------------------------------

HEIGHT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
ALBEDO = dict(name="albedo", texture_size=512, border_size=1, mip_level_count=4, format="RGBA8")
PLANAR_TERRAIN = dict(lod_count=3, atlas_size=16, path="terrains/border1")
PLANAR_VIEWS = (np.array([-120.0, 90.0, 160.0]), np.array([200.0, 60.0, -50.0]))


def _lit(pkg):
    return pkg.StandardMaterial(
        base_color=pkg.albedo_material(1), perceptual_roughness=0.6, metallic=0.2,
        reflectance=0.4,
        lights=(pkg.DirectionalLight(direction=(-0.3, -0.8, -0.5), color=(1.0, 0.9, 0.8),
                                     illuminance=0.9),
                pkg.PointLight(position=(120.0, 300.0, -80.0), range=3000.0, intensity=0.5)))


@pytest.fixture(scope="module")
def albedo_terrains(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_border1")
    for att in (AttachmentConfig(**HEIGHT),
                AttachmentConfig(**{**ALBEDO, "format": AttachmentFormat.RGBA8})):
        generate_planar_dataset(PLANAR_TERRAIN["path"], 3, att, root=str(root))
    return _terrains(root, ("planar", (np.zeros(3), 1000.0, 0.0, 100.0)), [HEIGHT, ALBEDO],
                     PLANAR_TERRAIN,
                     dict(tile_capacity=128, morph_distance=4.0, blend_distance=1.5),
                     dict(queue_capacity=512, blend_per_vertex=True))


@pytest.mark.parametrize("cam", [0, 1])
def test_border1_albedo_matches_jax_terrain(albedo_terrains, cam):
    port, jax_t = albedo_terrains
    height, albedo = port.atlas.attachments
    assert albedo.patch_plan != height.patch_plan and albedo.block_array is not None
    view = PLANAR_VIEWS[cam]
    count = lambda: (kernels.attach_sample_fused.launches,  # noqa: E731
                     kernels.attach_sample_fused_packed.launches)
    before = count()
    # unlit: the colours are the staged sampler's values
    port.set_shading(mat.albedo_material(1), lighting=False, sample_attachments=(1,))
    jax_t.set_shading(jmat.albedo_material(1), lighting=False, sample_attachments=(1,))
    out, jout = _stream(port, view), _stream(jax_t, view)
    np.testing.assert_array_equal(port.last_uniform_blob("cam"),
                                  np.asarray(jax_t._last_uniforms["cam"]))
    # the staged mesh in both packages
    rows, rows_j = _assert_same_frame(out, jout, dict(heights=2e-4, positions=2e-4, uvs=1e-6))
    i = np.array(list(rows.values()))
    j = np.array([rows_j[k] for k in rows])
    assert port._fused_material is None and out.raw_mesh is None
    got, want = out.colors.numpy()[i], np.asarray(jout.colors)[j]
    assert got.shape == want.shape == (len(i), 17, 17, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    grid = port.sample_attachment_grid("cam", out, 1).numpy()[i]
    np.testing.assert_allclose(grid, got, rtol=0, atol=1e-6)
    # the synthetic colour field: red rises along u from 0.1, alpha is 1
    assert got[..., 0].min() >= 0.09 and got[..., 3].min() > 0.99 and got[..., 0].std() > 0.05
    # lit: the staged material stage on the sampled albedo
    port.set_shading(_lit(mat), sample_attachments=(1,))
    jax_t.set_shading(_lit(jmat), sample_attachments=(1,))
    out = port.update({"cam": view})["cam"]
    jout = jax_t.update({"cam": view})["cam"]
    assert port._fused_material is None  # the albedo's plan is not the height's
    print(f"lit: max |port - JAX| colours "
          f"{np.abs(out.colors.numpy()[i] - np.asarray(jout.colors)[j]).max():.3e}")
    np.testing.assert_allclose(out.colors.numpy()[i], np.asarray(jout.colors)[j], rtol=0,
                               atol=1e-5)
    assert count() == before  # the staged sampler, and on the CPU no launch anyway


# -- 3. the per-vertex path ------------------------------------------------------

SMALL_ATT = dict(name="height", texture_size=32, border_size=1, mip_level_count=2)
SMALL_TERRAIN = dict(lod_count=4, atlas_size=128, path="terrains/per_vertex")


@pytest.fixture(scope="module")
def vertex_terrains(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_per_vertex")
    generate_planar_dataset(SMALL_TERRAIN["path"], 4, AttachmentConfig(**SMALL_ATT),
                            root=str(root))
    return _terrains(root, ("planar", (np.zeros(3), 1000.0, 0.0, 100.0)), [SMALL_ATT],
                     SMALL_TERRAIN, dict(tile_capacity=128), dict(queue_capacity=512))


@pytest.mark.parametrize("cam", [0, 1])
def test_per_vertex_matches_jax_terrain(vertex_terrains, cam):
    port, jax_t = vertex_terrains
    assert not port.use_grid_mesh and not jax_t.use_grid_mesh
    assert port.atlas.attachments[0].block_array is None
    view = PLANAR_VIEWS[cam]
    before = {name: getattr(kernels, name).launches for name in dir(kernels)
              if hasattr(getattr(kernels, name), "launches")}
    out, jout = _stream(port, view), _stream(jax_t, view)
    assert before == {name: getattr(kernels, name).launches for name in before}
    assert isinstance(out.mesh, meshgen.MeshOutput) and out.raw_mesh is None
    V = port._static_cfgs["cam"].vertices_per_tile
    assert out.mesh.heights.shape == (128, V)
    _assert_same_frame(out, jout, dict(heights=1e-3, positions=1e-3, uvs=1e-6, normals=0.0))
    h = out.mesh.heights[:out.tile_count]
    assert 0.0 <= float(h.min()) and float(h.max()) <= 100.0 and float(h.std()) > 5.0
    # the device slabs hold the loaded tiles in the attachment's own dtype
    slab = port.atlas.attachments[0].slabs[0]
    jslab = np.asarray(jax_t.atlas.attachments[0].slabs[0])
    assert slab.dtype == torch.uint16 and tuple(slab.shape) == jslab.shape == (128, 32, 32, 1)
    assert int(slab.view(torch.int16).count_nonzero()) > 0
    with pytest.raises(RuntimeError):
        port.sample_attachment_grid("cam", out, 0)
