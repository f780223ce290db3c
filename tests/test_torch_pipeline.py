"""The planar frame end to end: the torch package's Terrain on the CPU.

The scene is tools/make_goldens.py::mesh_case (planar 1000 m terrain,
3 lods of 512^2 R16 tiles, a 128-slot atlas, capacity 512, per-vertex
blend), streamed until quiescent with ``pallas_sampling=True`` (the fused
kernel's plain version), and on the CPU's default path (the staged mesh,
as the JAX Terrain on the CPU). Then:

1. the tile nodes equal the committed golden exactly, and heights and
   view-relative positions are within 2e-2 m of it on the fused path (the
   golden is the JAX package's staged path; 2e-2 is its fused-vs-staged
   yardstick, tests/test_fused_mesh.py) and within 1e-3 m on the staged
   path (the golden's own CPU bound, tests/test_goldens.py:136-138);
2. the port's final uniform blob and block array, fed to the JAX package's
   refinement + fused Pallas kernel (interpret mode), give the same tile
   list and heights and positions within 1e-3 m;
3. the JAX package's Terrain, streamed on the same dataset, packs the same
   uniform blob bit for bit (the copied host layer against the original),
   and a port atlas filled from its state through ``interop`` renders the
   same frame.
"""

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.ops import meshgen as jmeshgen
from bevy_terrain_tpu.ops import refinement as jrefinement
from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch import interop
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel
from bevy_terrain_tpu_torch.ops import meshgen
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.render.material import (
    StandardMaterial, albedo_material, kernel_shade_spec,
)
from bevy_terrain_tpu_torch.render.pipeline import Terrain
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "mesh_planar_streamed.npz"
VIEW = np.array([-120.0, 90.0, 160.0])
ATT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
TERRAIN = dict(lod_count=3, atlas_size=128, path="terrains/golden")
VIEW_CONFIG = dict(tile_capacity=512, morph_distance=4.0, blend_distance=1.5)
VIEW_KW = dict(queue_capacity=2048, blend_per_vertex=True)


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


def _port_terrain(root, pallas_sampling=True):
    config = TerrainConfig(
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        attachments=(AttachmentConfig(**ATT),), assets_root=str(root), **TERRAIN,
    )
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(**VIEW_CONFIG), **VIEW_KW,
                     pallas_sampling=pallas_sampling)
    return terrain


def _strip_capture(out, cfg):
    """(sorted nodes, strip heights, view-relative strip positions), the
    golden's capture (tools/make_goldens.py::_capture_streamed)."""
    n = out.tile_count
    t = out.tiles
    nodes = torch.stack(
        [t.tile_side[:n], t.tile_lod[:n], t.tile_xy[:n, 0], t.tile_xy[:n, 1]], dim=-1
    ).numpy().astype(np.int32)
    order = np.lexsort(nodes.T[::-1])
    heights = jmeshgen.grid_to_strip_order(out.mesh.heights.numpy(), cfg)[:n][order]
    positions = jmeshgen.grid_to_strip_order(out.mesh.positions.numpy(), cfg)[:n][order]
    relative = positions - VIEW
    return nodes[order], heights.astype(np.float32), relative.astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipeline")
    generate_planar_dataset(TERRAIN["path"], TERRAIN["lod_count"], AttachmentConfig(**ATT),
                            root=str(root))
    return root


@pytest.fixture(scope="module")
def port_frame(dataset):
    """The fused path (the kernel's plain version)."""
    terrain = _port_terrain(dataset)
    out = _stream(terrain)
    return terrain, out


@pytest.fixture(scope="module")
def staged_frame(dataset):
    """The CPU's default path: the staged mesh, torch ops."""
    terrain = _port_terrain(dataset, pallas_sampling=False)
    return terrain, _stream(terrain)


@pytest.fixture(scope="module")
def jax_terrain(dataset):
    from bevy_terrain_tpu import Terrain as JTerrain
    from bevy_terrain_tpu import AttachmentConfig as JAtt
    from bevy_terrain_tpu import TerrainConfig as JConfig
    from bevy_terrain_tpu import TerrainModel as JModel
    from bevy_terrain_tpu import TerrainViewConfig as JViewConfig

    config = JConfig(
        model=JModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        attachments=(JAtt(**ATT),), assets_root=str(dataset), **TERRAIN,
    )
    terrain = JTerrain(config)
    terrain.add_view("cam", JViewConfig(**VIEW_CONFIG), **VIEW_KW)
    _stream(terrain)
    return terrain


def test_frame_is_clean(port_frame):
    terrain, out = port_frame
    assert out.tile_count > 0 and out.overflow == 0
    n = out.tile_count
    mesh = out.mesh
    for field in ("heights", "positions", "uvs"):
        assert torch.isfinite(getattr(mesh, field)).all(), field
    h = mesh.heights[:n]
    model = terrain.config.model
    assert float(h.min()) >= model.min_height and float(h.max()) <= model.max_height


@pytest.mark.parametrize("path,tol", [("fused", 2e-2), ("staged", 1e-3)])
def test_matches_committed_golden(request, path, tol):
    """Staged within the golden's own 1e-3 m (measured 2.3e-5 m heights,
    6.1e-5 m positions); fused within the fused-vs-staged 2e-2 m (measured
    7.2e-5 m both)."""
    terrain, out = request.getfixturevalue({"fused": "port_frame", "staged": "staged_frame"}[path])
    assert (out.raw_mesh is not None) == (path == "fused")
    nodes, heights, positions = _strip_capture(out, terrain._static_cfgs["cam"])
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(nodes, g["nodes"])
    print(f"{path}: max |port - golden| heights {np.abs(heights - g['heights']).max():.3e}, "
          f"positions {np.abs(positions - g['positions']).max():.3e}")
    np.testing.assert_allclose(heights, g["heights"], rtol=0, atol=tol)
    np.testing.assert_allclose(positions, g["positions"], rtol=0, atol=tol)


def test_matches_jax_fused_kernel(port_frame):
    terrain, out = port_frame
    cfg = terrain._static_cfgs["cam"]
    jcfg = JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    blob = terrain.last_uniform_blob("cam")
    height = terrain.atlas.attachments[0]
    ju = junpack(jnp.asarray(blob), cfg.side_count, cfg.lod_count, cfg.tree_size)

    @jax.jit  # compiled once, as the JAX pipeline runs it
    def jframe(ju, blocks):
        jraw, jtiles = jmeshgen.generate_mesh_fused(
            jrefinement.refine_tiles(ju, jcfg), blocks, ju, jcfg, height.patch_plan,
            height.config.format.max_value, interpret=True)
        return jtiles, jmeshgen.fused_to_grid(jraw, jtiles, jcfg)

    jtiles, jmesh = jax.block_until_ready(jframe(ju, jnp.asarray(height.block_array.numpy())))
    n = out.tile_count
    assert int(jtiles.tile_count) == n and int(jtiles.overflow) == 0
    for field in ("tile_side", "tile_lod", "tile_xy"):
        np.testing.assert_array_equal(getattr(out.tiles, field).numpy(),
                                      np.asarray(getattr(jtiles, field)), err_msg=field)
    for field in ("heights", "positions"):
        np.testing.assert_allclose(getattr(out.mesh, field)[:n].numpy(),
                                   np.asarray(getattr(jmesh, field))[:n],
                                   rtol=0, atol=1e-3, err_msg=field)
    np.testing.assert_allclose(out.mesh.uvs[:n].numpy(), np.asarray(jmesh.uvs)[:n],
                               rtol=0, atol=1e-6)


def test_host_blob_matches_jax_terrain(port_frame, jax_terrain):
    terrain, _ = port_frame
    want = np.asarray(jax_terrain._last_uniforms["cam"])
    np.testing.assert_array_equal(terrain.last_uniform_blob("cam"), want)


def test_interop_carries_jax_atlas(dataset, port_frame, jax_terrain):
    """A fresh port Terrain filled from the JAX atlas (as numpy) renders the
    same first frame as the streamed port Terrain, with no tile loads."""
    _, out = port_frame
    jatlas = jax_terrain.atlas
    terrain = _port_terrain(dataset)
    interop.atlas_from_numpy(
        terrain.atlas,
        [np.asarray(a.block_array) for a in jatlas.attachments],
        [list(a.data) for a in jatlas.attachments],
        {(c.side, c.lod, c.x, c.y): (s.atlas_index, 0, s.loading_remaining)
         for c, s in jatlas.state.tile_states.items()},
    )
    got = terrain.update({"cam": VIEW})["cam"]
    assert not terrain.atlas.state.to_load
    np.testing.assert_array_equal(terrain.last_uniform_blob("cam"),
                                  np.asarray(jax_terrain._last_uniforms["cam"]))
    assert got.tile_count == out.tile_count
    np.testing.assert_array_equal(got.raw_mesh.numpy(), out.raw_mesh.numpy())
    blob = interop.blob_to_device(np.asarray(jax_terrain._last_uniforms["cam"]), "cpu")
    assert blob.dtype == torch.int32
    np.testing.assert_array_equal(blob.numpy(), terrain.last_uniform_blob("cam"))


def _raising_terrain(tmp_path, sphere=False, grid_size=16, atts=()):
    """A CPU Terrain on an empty dataset: the 1000 m plane, or a 6.4e6 m
    sphere, with one view of the given grid size and ``pallas_sampling``
    on (the fused kernel's plain version where the view allows it)."""
    model = TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0)
    if sphere:
        model = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
    config = TerrainConfig(model=model, attachments=(AttachmentConfig(**ATT), *atts),
                           assets_root=str(tmp_path), **{**TERRAIN, "atlas_size": 4})
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(grid_size=grid_size, tile_capacity=64),
                     queue_capacity=256, pallas_sampling=True)
    return terrain


@pytest.mark.parametrize("case", ["spherical", "grid_size", "shading"])
def test_fused_kernel_args_reject_what_the_kernels_do_not_cover(tmp_path, case):
    """``meshgen.fused_kernel_args`` raises NotImplementedError for what the
    fused kernels do not cover, rather than packing arguments they would
    misread: a sphere without the Taylor path and a grid size other than 16
    (the pipeline sends both through the staged path: at grid size 8 the
    frame has no raw kernel output), and the in-kernel shade on a sphere
    (its normals are a planar central difference; the pipeline shades a
    planet with render/material.shade)."""
    sphere = case in ("spherical", "shading")
    terrain = _raising_terrain(tmp_path, sphere, 8 if case == "grid_size" else 16)
    cfg = terrain._static_cfgs["cam"]
    height = terrain.atlas.attachments[0]
    out = terrain.update({"cam": VIEW * (1e5 if sphere else 1.0)})["cam"]
    assert (out.raw_mesh is None) == (case == "grid_size")
    uniforms, _ = terrain.frame_inputs("cam")
    if case == "spherical":
        cfg = dataclasses.replace(cfg, high_precision=False)
    shade = {}
    if case == "shading":
        spec = kernel_shade_spec(StandardMaterial(base_color=albedo_material(0)), 255.0)
        shade = dict(albedo_blocks=height.block_array, albedo_channels=4, albedo_bits=8,
                     shade_spec=spec)
    with pytest.raises(NotImplementedError):
        meshgen.fused_kernel_args(out.tiles, height.block_array, uniforms, cfg,
                                  height.patch_plan, 65535.0, **shade)


def test_sampling_an_attachment_too_small_for_the_patch_plan_raises(tmp_path):
    """A material that samples an attachment too small for the patch plan
    (32^2 texels, border 1) raises NotImplementedError at set_shading: there
    is no block array to sample at the mesh's vertices."""
    albedo = AttachmentConfig(name="albedo", texture_size=32, border_size=1,
                              format=AttachmentFormat.RGBA8)
    terrain = _raising_terrain(tmp_path, atts=(albedo,))
    with pytest.raises(NotImplementedError):
        terrain.set_shading(StandardMaterial(base_color=albedo_material(1)),
                            sample_attachments=(1,))
