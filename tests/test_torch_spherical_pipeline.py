"""The spherical Earth frame end to end: the torch package's Terrain on the
CPU against the JAX package.

The scene is tools/make_goldens.py::mesh_spherical_case, the flagship Earth
frame of tools/earth_frame_bench.py: a 6.371e6 m cube sphere, 13 geometry
lods over 3 data lods of 512^2 R16 tiles, a 512-slot atlas, capacity 2048,
a 60-degree culled camera at 60 km, the Taylor high-precision path. Its
dataset is the golden's own (the JAX package's Preprocessor on the same
six analytic faces). Both packages stream it to quiescence. Then:

1. the frame is clean: >100 tiles, no overflow, finite output, heights in
   the model's range, unit normals;
2. the JAX Terrain packs the same uniform blob bit for bit;
3. the port's blob and block array, fed to the JAX package's refinement and
   fused Pallas kernel (interpret mode), give the same tile list and a mesh
   within the fused-vs-staged yardsticks (uvs within 5e-6: see
   EARTH_UV_TOL), and the port is as close to its own float64 arithmetic;
4. against the committed golden (the staged path): nodes exactly, and on
   the deep subset (lod >= 10) heights within 1e-1 m and view-relative
   positions within 3.0 m (the fused-vs-staged yardsticks,
   test_fused_mesh.py:167-177).

A second, smaller planet is written by ``generate_spherical_dataset`` (the
six-side fixture that the card's smoke run streams) and streamed by both
packages on a sphere and on an ellipsoid: the same blob, a clean frame.
"""

import inspect
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
from bevy_terrain_tpu_torch.config import AttachmentConfig, TerrainConfig, TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, frustum
from bevy_terrain_tpu_torch.render.pipeline import Terrain
from bevy_terrain_tpu_torch.utils.synthetic import generate_spherical_dataset
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "mesh_spherical_streamed.npz"
R = 6.371e6
VIEW = np.array([0.0, 0.0, R + 60_000.0])
VIEW_PROJ = frustum.view_projection(VIEW, VIEW * 0.5, np.pi / 3, 16 / 9)
ATT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
TERRAIN = dict(lod_count=13, atlas_size=512, path="terrains/golden_sph")
VIEW_KW = dict(queue_capacity=2048, culling=True, blend_per_vertex=True)


def _stream(terrain, view=VIEW, view_proj=VIEW_PROJ):
    """Update until no tile is loading, then return one more frame."""
    for _ in range(60):
        terrain.update({"cam": view}, {"cam": view_proj})
        if not terrain.atlas.state.to_load and not any(
            a.loading for a in terrain.atlas.attachments
        ):
            break
        time.sleep(0.01)
    return terrain.update({"cam": view}, {"cam": view_proj})["cam"]


def _jax_terrain(root, model_args, terrain_kw, att, ctor="sphere"):
    from bevy_terrain_tpu import AttachmentConfig as JAtt
    from bevy_terrain_tpu import Terrain as JTerrain
    from bevy_terrain_tpu import TerrainConfig as JConfig
    from bevy_terrain_tpu import TerrainModel as JModel
    from bevy_terrain_tpu import TerrainViewConfig as JViewConfig

    config = JConfig(model=getattr(JModel, ctor)(*model_args), attachments=(JAtt(**att),),
                     assets_root=str(root), **terrain_kw)
    terrain = JTerrain(config)
    terrain.add_view("cam", JViewConfig(tile_capacity=2048), **VIEW_KW)
    return terrain


def _port_terrain(root, model_args, terrain_kw, att, ctor="sphere"):
    config = TerrainConfig(model=getattr(TerrainModel, ctor)(*model_args),
                           attachments=(AttachmentConfig(**att),), assets_root=str(root),
                           **terrain_kw)
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=2048), **VIEW_KW)
    return terrain


MODEL = (np.zeros(3), R, 0.0, 9000.0)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The golden's dataset: tools/make_goldens.py::mesh_spherical_case's
    six analytic faces through the JAX package's Preprocessor."""
    from bevy_terrain_tpu import AttachmentConfig as JAtt
    from bevy_terrain_tpu import Preprocessor, SphericalDataset
    from bevy_terrain_tpu import TerrainConfig as JConfig
    from bevy_terrain_tpu import TerrainModel as JModel
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu.terrain_data import TileAtlas as JTileAtlas

    root = tmp_path_factory.mktemp("torch_spherical_pipeline")
    n = 256
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    src = root / "src"
    src.mkdir()
    paths = []
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        h = np.clip(0.45 + 0.25 * np.sin(3 * x + 1) * np.cos(4 * y)
                    + 0.18 * np.sin(5 * z + 2), 0.02, 1.0)
        path = src / f"face{side}.png"
        array_to_source(h, path)
        paths.append(str(path))
    config = JConfig(model=JModel.sphere(*MODEL), attachments=(JAtt(**ATT),),
                     assets_root=str(root), **TERRAIN)
    Preprocessor(JTileAtlas(config)).clear_attachment(0).preprocess_spherical(
        SphericalDataset(attachment_index=0, paths=paths, lod_range=range(0, 3))
    ).run(verbose=False)
    return root


@pytest.fixture(scope="module")
def port_frame(dataset):
    terrain = _port_terrain(dataset, MODEL, TERRAIN, ATT)
    return terrain, _stream(terrain)


@pytest.fixture(scope="module")
def jax_terrain(dataset):
    terrain = _jax_terrain(dataset, MODEL, TERRAIN, ATT)
    _stream(terrain)
    return terrain


def _assert_clean(terrain, out):
    n = out.tile_count
    assert n > 100 and out.overflow == 0
    assert out.raw_mesh.shape[1:] == (9, 17, 17)
    mesh = out.mesh
    for field in ("heights", "positions", "uvs", "normals"):
        assert torch.isfinite(getattr(mesh, field)).all(), field
    h = mesh.heights[:n]
    model = terrain.config.model
    assert float(h.min()) >= model.min_height and float(h.max()) <= model.max_height
    norm = torch.linalg.vector_norm(mesh.normals[:n].double(), dim=-1)
    assert float((norm - 1.0).abs().max()) <= 1e-5


def test_frame_is_clean(port_frame):
    _assert_clean(*port_frame)


def test_host_blob_matches_jax_terrain(port_frame, jax_terrain):
    terrain, _ = port_frame
    np.testing.assert_array_equal(terrain.last_uniform_blob("cam"),
                                  np.asarray(jax_terrain._last_uniforms["cam"]))


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


def test_matches_committed_golden(port_frame):
    from tools.make_goldens import spherical_deep_subset

    terrain, out = port_frame
    nodes, heights, positions = _strip_capture(out, terrain._static_cfgs["cam"])
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(nodes, g["nodes"])
    dn, dh, dp = spherical_deep_subset(nodes, heights, positions)
    np.testing.assert_array_equal(dn, g["deep_nodes"])
    np.testing.assert_allclose(dh, g["deep_heights"], rtol=0, atol=1e-1)
    np.testing.assert_allclose(dp, g["deep_positions"], rtol=0, atol=3.0)


# uvs at the streamed Earth frame: its world-frame vertices 6-60 km from the
# view sit in morph zones, where one planet-scale f32 ulp in the view
# distance moves the morph ratio; against the float64 arithmetic of the same
# inputs the port's uvs are 3.0e-6 off and the JAX kernel's 3.1e-6
# (measured), so 1e-6 holds for neither. Heights, positions and normals keep
# the fused-vs-staged yardsticks (measured port-vs-JAX 2.0e-3 m, 1.5 m,
# 2.4e-7).
EARTH_UV_TOL = 5e-6


def test_matches_jax_fused_kernel(port_frame):
    """The port's blob and blocks through the JAX refinement and fused
    kernel (interpret mode): the same tile list; the mesh within heights
    1e-1 m, view-relative positions 3.0 m, uvs :data:`EARTH_UV_TOL`,
    normals 1e-5; and the port within the same bounds of its own arithmetic
    in float64."""
    from bevy_terrain_tpu_torch.ops import kernels

    terrain, out = port_frame
    cfg = terrain._static_cfgs["cam"]
    jcfg = JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    blob = terrain.last_uniform_blob("cam")
    height = terrain.atlas.attachments[0]
    ju = junpack(jnp.array(blob), cfg.side_count, cfg.lod_count, cfg.tree_size)
    jraw, jtiles = jmeshgen.generate_mesh_fused(
        jrefinement.refine_tiles(ju, jcfg), jnp.array(height.block_array.numpy()), ju,
        jcfg, height.patch_plan, height.config.format.max_value, interpret=True,
    )
    jmesh = jax.block_until_ready(jmeshgen.fused_to_grid(jraw, jtiles, jcfg, ju))
    n = out.tile_count
    assert int(jtiles.tile_count) == n and int(jtiles.overflow) == 0
    for field in ("tile_side", "tile_lod", "tile_xy"):
        np.testing.assert_array_equal(getattr(out.tiles, field)[:n].numpy(),
                                      np.asarray(getattr(jtiles, field))[:n], err_msg=field)
    exact = list(out.mesh_inputs)
    for k in (2, 3, 4):  # geom, tile_params, fs in float64
        exact[k] = exact[k].double()
    exact = kernels.mesh_fused_spherical_reference(*exact)[:n]
    want_exact = dict(heights=exact[:, 0], positions=exact[:, 1:4].permute(0, 2, 3, 1),
                      uvs=exact[:, 4:6].permute(0, 2, 3, 1),
                      normals=exact[:, 6:9].permute(0, 2, 3, 1))
    tol = dict(heights=1e-1, positions=3.0, uvs=EARTH_UV_TOL, normals=1e-5)
    for field, atol in tol.items():
        got = getattr(out.mesh, field)[:n].numpy().astype(np.float64)
        want = np.asarray(getattr(jmesh, field))[:n].astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=field)
        np.testing.assert_allclose(got, want_exact[field].numpy(), rtol=0, atol=atol,
                                   err_msg=field)


# the sphere, and the WGS84-like ellipsoid of models.earth_ellipsoid
SYNTHETIC_MODELS = {"sphere": ("sphere", MODEL),
                    "ellipsoid": ("ellipsoid", (np.zeros(3), 6_378_137.0, 6_356_752.3,
                                                -11_000.0, 9000.0))}


@pytest.mark.parametrize("kind", sorted(SYNTHETIC_MODELS))
def test_synthetic_sphere_streams_in_both_packages(tmp_path, kind):
    """``generate_spherical_dataset`` writes a planet both packages stream
    (3 data lods of 256^2 tiles under 8 geometry lods), on a sphere and on
    an ellipsoid: the same blob, a clean frame."""
    ctor, model_args = SYNTHETIC_MODELS[kind]
    att = dict(name="height", texture_size=256, border_size=2, mip_level_count=3)
    terrain_kw = dict(lod_count=8, atlas_size=256, path="synthetic_sphere")
    tiles = generate_spherical_dataset("synthetic_sphere", 3, AttachmentConfig(**att),
                                       root=str(tmp_path))
    assert len(tiles) == 6 * (1 + 4 + 16)
    assert {t.side for t in tiles} == set(range(6))
    port = _port_terrain(tmp_path, model_args, terrain_kw, att, ctor)
    out = _stream(port)
    _assert_clean(port, out)
    assert port._static_cfgs["cam"].ellipsoidal == (kind == "ellipsoid")
    jt = _jax_terrain(tmp_path, model_args, terrain_kw, att, ctor)
    _stream(jt)
    np.testing.assert_array_equal(port.last_uniform_blob("cam"),
                                  np.asarray(jt._last_uniforms["cam"]))
    # the loaded heights follow the analytic field: not flat ground
    h = out.mesh.heights[:out.tile_count]
    assert float(h.max() - h.min()) > 1000.0


def test_terrain_runs_on_the_card_by_default():
    """``Terrain(config)`` puts the atlas and the frame on the CUDA card
    unless the caller asks for the CPU (read from the signature: building
    one here would allocate on a card this machine may not have)."""
    assert inspect.signature(Terrain).parameters["device"].default == "cuda"
