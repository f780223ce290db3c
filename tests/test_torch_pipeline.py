"""The planar frame end to end: the torch package's Terrain on the CPU.

The scene is tools/make_goldens.py::mesh_case (planar 1000 m terrain,
3 lods of 512^2 R16 tiles, a 128-slot atlas, capacity 512, per-vertex
blend), streamed until quiescent. Then:

1. the tile nodes equal the committed golden exactly, and heights and
   view-relative positions are within 2e-2 m of it (the golden is the
   JAX package's staged path; 2e-2 is its fused-vs-staged yardstick,
   tests/test_fused_mesh.py);
2. the port's final uniform blob and block array, fed to the JAX package's
   refinement + fused Pallas kernel (interpret mode), give the same tile
   list and heights and positions within 1e-3 m;
3. the JAX package's Terrain, streamed on the same dataset, packs the same
   uniform blob bit for bit (the copied host layer against the original),
   and a port atlas filled from its state through ``interop`` renders the
   same frame.
"""

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
from bevy_terrain_tpu_torch.render.material import StandardMaterial, albedo_material
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


def _port_terrain(root):
    config = TerrainConfig(
        model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
        attachments=(AttachmentConfig(**ATT),), assets_root=str(root), **TERRAIN,
    )
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(**VIEW_CONFIG), **VIEW_KW)
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
    terrain = _port_terrain(dataset)
    out = _stream(terrain)
    return terrain, out


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


def test_matches_committed_golden(port_frame):
    terrain, out = port_frame
    nodes, heights, positions = _strip_capture(out, terrain._static_cfgs["cam"])
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(nodes, g["nodes"])
    np.testing.assert_allclose(heights, g["heights"], rtol=0, atol=2e-2)
    np.testing.assert_allclose(positions, g["positions"], rtol=0, atol=2e-2)


def test_matches_jax_fused_kernel(port_frame):
    terrain, out = port_frame
    cfg = terrain._static_cfgs["cam"]
    jcfg = JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    blob = terrain.last_uniform_blob("cam")
    height = terrain.atlas.attachments[0]
    ju = junpack(jnp.asarray(blob), cfg.side_count, cfg.lod_count, cfg.tree_size)
    jraw, jtiles = jmeshgen.generate_mesh_fused(
        jrefinement.refine_tiles(ju, jcfg), jnp.asarray(height.block_array.numpy()), ju,
        jcfg, height.patch_plan, height.config.format.max_value, interpret=True,
    )
    jmesh = jax.block_until_ready(jmeshgen.fused_to_grid(jraw, jtiles, jcfg))
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


@pytest.mark.parametrize("case", ["spherical", "grid_size", "small_attachment", "shading"])
def test_unported_configurations_raise(tmp_path, case):
    """Configurations outside the ported slice raise NotImplementedError
    instead of silently taking another path. A sphere is ported with the
    Taylor high-precision path only (the JAX fused kernel's own rule); a
    sampled attachment must share the height attachment's patch plan (a
    border-1 albedo beside the border-2 height needs the per-tile fallback
    sampler, not ported)."""
    atts = (AttachmentConfig(**ATT),)
    model = TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0)
    if case == "spherical":
        model = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)
    if case == "small_attachment":
        atts = (AttachmentConfig(name="height", texture_size=32, border_size=1),)
    if case == "shading":
        atts += (AttachmentConfig(name="albedo", texture_size=512, border_size=1,
                                  mip_level_count=4, format=AttachmentFormat.RGBA8),)
    config = TerrainConfig(model=model, attachments=atts, assets_root=str(tmp_path),
                           **{**TERRAIN, "atlas_size": 4})
    with pytest.raises(NotImplementedError):
        terrain = Terrain(config, device="cpu")
        if case == "spherical":
            terrain.add_view("cam", TerrainViewConfig(), high_precision=False)
        elif case == "grid_size":
            terrain.add_view("cam", TerrainViewConfig(grid_size=8))
        elif case == "shading":
            terrain.set_shading(StandardMaterial(base_color=albedo_material(1)),
                                sample_attachments=(1,))
