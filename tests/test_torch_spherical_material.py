"""The spherical material frame end to end: the torch package's ``Terrain`` on
the CPU against the JAX package's, on the same files.

A synthetic six-side planet (``generate_spherical_dataset``: 3 data lods of
256^2 R16 heights and an Rgba8 albedo of the same plan, a colour field of the
unit cube-sphere position, under 6 geometry lods, capacity 2048) is streamed
to quiescence by both packages at two culled cameras, with
``set_shading(StandardMaterial(base_color=albedo_material(1)),
sample_attachments=(1,))`` lit, and with the bare ``albedo_material(1)``
unlit.

The port's view has ``pallas_sampling=True`` and takes the fused spherical
mesh kernel (K2; its plain version here), the packed sampler (K5b) at the
kernel's morphed uvs and
``render/material.shade`` with the kernel's sphere normals, never the
in-kernel shade (planar only, as in the JAX pipeline). The JAX package on
the CPU takes its staged mesh and XLA sampler. Per tile key: the same tile
set, colours well within 2/255, test_torch_material.py's yardstick (the
bounds and the measured values are at :data:`TOL`; ``pytest -rP`` prints
them).
"""

import numpy as np
import pytest
import torch

from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu_torch.config import AttachmentConfig, AttachmentFormat
from bevy_terrain_tpu_torch.ops import kernels, meshgen
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.utils.synthetic import (
    default_sphere_color_fn, generate_spherical_dataset, spherical_tile_payload,
)
from bevy_terrain_tpu_torch.math import TileCoordinate, frustum
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_staged_pipeline import R, SPH_VIEWS, _rows, _stream, _terrains

ATTS = [dict(name="height", texture_size=256, border_size=2, mip_level_count=3),
        dict(name="albedo", texture_size=256, border_size=2, mip_level_count=3,
             format="RGBA8")]
TERRAIN = dict(lod_count=6, atlas_size=128, path="material_sphere")
# colours in [0, 1]. Measured max |port - JAX|: unlit 2.4e-7 (the sampler at
# uvs within 1e-6), lit 5.8e-7 (the fused and the staged mesh's heights differ
# in summation order only, and the smooth field's normals barely amplify it).
# The lit bound is a hundredth of the 2/255 yardstick of test_torch_material.py.
TOL = {"unlit": 1e-5, "lit": 1e-4}


def _proj(view):
    return frustum.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)


def _materials(pkg):
    lights = (pkg.DirectionalLight(direction=(-0.3, -0.2, -0.9), color=(1.0, 0.95, 0.9),
                                   illuminance=0.9),)
    return {"lit": dict(material=pkg.StandardMaterial(base_color=pkg.albedo_material(1),
                                                      perceptual_roughness=0.7, lights=lights)),
            "unlit": dict(material=pkg.albedo_material(1), lighting=False)}


@pytest.fixture(scope="module")
def planets(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_spherical_material")
    for att in ATTS:
        fmt = getattr(AttachmentFormat, att.get("format", "R16"))
        generate_spherical_dataset(TERRAIN["path"], 3, AttachmentConfig(**{**att, "format": fmt}),
                                   root=str(root))
    return _terrains(root, ("sphere", (np.zeros(3), R, 0.0, 9000.0)), ATTS, TERRAIN,
                     dict(tile_capacity=2048), dict(queue_capacity=4096, culling=True),
                     dict(pallas_sampling=True))


def test_spherical_dataset_writes_a_colour_attachment():
    """A multi-channel payload holds the colour field of the unit position:
    continuous across sides, channel 0 never zero (the nodata sentinel)."""
    att = AttachmentConfig(name="albedo", texture_size=64, border_size=2, mip_level_count=2,
                           format=AttachmentFormat.RGBA8)
    tiles = [spherical_tile_payload(TileCoordinate(s, 1, 1, 0), att,
                                    lambda p: default_sphere_color_fn(p))
             for s in range(6)]
    for t in tiles:
        assert t.shape == (64, 64, 4) and t.dtype == np.uint8
        assert t[..., 0].min() >= 1 and (t[..., 3] == 255).all() and t[..., :3].std() > 5
    rng = np.random.default_rng(0)
    p = rng.normal(size=(1000, 3))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    c = default_sphere_color_fn(p)
    assert c.shape == (1000, 4) and c.min() >= 0.0 and c.max() <= 1.0 and c[:, 0].min() > 0.1
    with pytest.raises(ValueError):  # a 3-channel field for a 4-channel format
        spherical_tile_payload(TileCoordinate(0, 0, 0, 0), att,
                               lambda p: default_sphere_color_fn(p)[..., :3])


@pytest.mark.parametrize("shading", ["lit", "unlit"])
@pytest.mark.parametrize("cam", [0, 1])
def test_planet_colours_match_jax_terrain(planets, cam, shading):
    port, jax_t = planets
    port.set_shading(sample_attachments=(1,), **_materials(mat)[shading])
    jax_t.set_shading(sample_attachments=(1,), **_materials(jmat)[shading])
    assert port._fused_material is None or port._static_cfgs["cam"].spherical
    before = {k: getattr(kernels, k).launches for k in ("mesh_fused_shaded",
                                                        "mesh_fused_spherical")}
    view = SPH_VIEWS[cam]
    out, jout = _stream(port, view, _proj(view)), _stream(jax_t, view, _proj(view))
    # on the CPU the wrappers run their plain versions: no launch counted
    assert before == {k: getattr(kernels, k).launches for k in before}
    n = out.tile_count
    assert n == int(jout.tile_count) > 100 and out.overflow == int(jout.overflow) == 0
    # the fused spherical mesh (9 channels: no colours ride the raw tensor)
    assert out.raw_mesh.shape[1:] == (kernels.SPH_CH, 17, 17)
    rows, rows_j = _rows(out.tiles, n), _rows(jout.tiles, n)
    assert set(rows) == set(rows_j)
    i = np.array(list(rows.values()))
    j = np.array([rows_j[k] for k in rows])
    got = out.colors.numpy()
    want = np.asarray(jout.colors)
    assert got.shape == want.shape == (2048, 17, 17, 4) and np.isfinite(got).all()
    err = float(np.abs(got[i] - want[j]).max())
    print(f"camera {cam} {shading}: {n} tiles, colours in [{got[i].min():.4f}, "
          f"{got[i].max():.4f}], max |port - JAX| {err:.3e} (tol {TOL[shading]:.1e})")
    assert err <= TOL[shading]
    assert not got[n:].any() and got[i][..., :3].std() > 0.02
    if shading == "unlit":
        # the colours are the packed sampler's values at the mesh's uvs
        grid = port.sample_attachment_grid("cam", out, 1)
        np.testing.assert_allclose(got[i], grid.numpy()[i], rtol=0, atol=1e-6)
        assert float(grid[:n][..., 0].min()) > 0.1 and float(grid[:n][..., 3].min()) > 0.99
    else:
        # lit with the kernel's sphere normals through render/material.shade
        uniforms, cfg = port.frame_inputs("cam")
        samples = {1: port.sample_attachment_grid("cam", out, 1)}
        want_port = mat.shade(out.mesh, out.tiles, uniforms, cfg, attachment_samples=samples,
                              texture_size=256, **_materials(mat)["lit"])
        assert torch.equal(out.colors, want_port)
        assert torch.equal(out.mesh.normals,
                           out.raw_mesh[:, 6:9].permute(0, 2, 3, 1))


def test_k3s_colours_equal_the_pipelines(planets):
    """``meshgen.generate_mesh_fused`` with the planet's albedo (K3s) on the
    last frame's tiles: mesh channels equal the frame's, exact colours equal
    the pipeline's sampled ones within 1e-6, fast ones within 2/255."""
    port, _ = planets
    port.set_shading(sample_attachments=(1,), **_materials(mat)["unlit"])
    out = _stream(port, SPH_VIEWS[0], _proj(SPH_VIEWS[0]))
    uniforms, cfg = port.frame_inputs("cam")
    height, albedo = port.atlas.attachments
    n = out.tile_count
    for fast, tol in ((False, 1e-6), (True, 2.0 / 255.0)):
        raw, tiles = meshgen.generate_mesh_fused(
            out.tiles, height.block_array, uniforms, cfg, height.patch_plan,
            height.config.format.max_value, albedo_blocks=albedo.block_array,
            albedo_channels=4, albedo_bits=8, albedo_fast=fast)
        assert torch.equal(tiles.tile_xy, out.tiles.tile_xy)
        assert torch.equal(raw[:, :kernels.SPH_CH], out.raw_mesh)
        rgba = meshgen.fused_albedo_to_grid(raw, cfg, 4, 255.0)
        err = float((rgba[:n] - out.colors[:n]).abs().max())
        print(f"K3s {'fast' if fast else 'exact'} vs the pipeline's colours: {err:.3e}")
        assert err <= tol
