"""The ``pallas_sampling`` switch: one rule picks the hand kernels in the port,
as in the JAX package (``bevy_terrain_tpu/render/pipeline.py:225``,
``:457-464``, ``ops/meshgen.py:101``, ``ops/patch_sampling.py:603-605``).

1. A truth table: the port's ``Terrain.use_fused``, and the multi-view
   terrain's, against the JAX ``Terrain._use_fused`` over the switch, grid
   sizes 16 and 8 and the four spherical x high_precision pairs.
2. The switch reaches each site on a tiny planar scene (a height and a
   packed Rgba8 albedo with the height's patch plan, sampled by an unlit
   albedo material) on the CPU. Each kernel wrapper of the frame is spied
   on: by default the switch is off on the CPU, as in the JAX package off
   the TPU, and no wrapper is called (the fused mesh, K6 and the sampler
   kernels all give way to torch ops); with the switch on the fused mesh
   and the packed sampler run, or K6 and the packed sampler on a staged
   view (planar with the Taylor path). ``MultiViewTerrain`` takes the same
   decision. The ``.launches`` counters do not move on the CPU either way.
3. The port's default ``Terrain`` against the JAX ``Terrain`` on the same
   files, the staged path on both sides: the same blob, tile set, and per
   tile heights and positions within :data:`SAME_PATH_M`, uvs within 1e-6
   (tests/test_goldens.py:136-138, the reference's planar mesh bounds), the
   unlit colours within 1e-5.
"""

import itertools
import time

import numpy as np
import pytest

from bevy_terrain_tpu.render import material as jmat
from bevy_terrain_tpu.render.pipeline import Terrain as JTerrain
from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel
from bevy_terrain_tpu_torch.ops import kernels
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig
from bevy_terrain_tpu_torch.parallel import MultiViewTerrain
from bevy_terrain_tpu_torch.parallel.multi_view import _ViewsTerrain
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.render.pipeline import Terrain
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_staged_pipeline import _stream, _terrains

WRAPPERS = ("mesh_fused_planar", "mesh_fused_shaded", "mesh_fused_albedo",
            "fetch_resample_cached", "attach_sample_fused", "attach_sample_fused_packed")
HEIGHT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
ALBEDO = dict(name="albedo", texture_size=512, border_size=2, mip_level_count=4, format="RGBA8")
TERRAIN = dict(lod_count=3, atlas_size=32, path="terrains/switch")
VIEW_CONFIG = dict(tile_capacity=64, morph_distance=2.0, blend_distance=1.5)
VIEW_KW = dict(queue_capacity=512)
VIEW = np.array([-120.0, 150.0, 160.0])
# the port's staged mesh against the JAX package's staged mesh on this scene:
# measured 5.3e-5 m heights, 6.1e-5 m positions (a few f32 ulps of the 100 m
# range), 1.9e-7 uvs, 3.6e-7 colours; the bound keeps a margin of 3 and is a
# fifth of the reference's 1e-3 m
SAME_PATH_M = 2e-4


@pytest.mark.parametrize("switch,grid,spherical,high_precision", list(itertools.product(
    (False, True), (16, 8), (False, True), (False, True))))
def test_use_fused_is_the_jax_rule(switch, grid, spherical, high_precision):
    from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig

    kw = dict(spherical=spherical, side_count=6 if spherical else 1, lod_count=3,
              tree_size=8, grid_size=grid, refinement_count=8, queue_capacity=64,
              tile_capacity=64, origin_lod=0, high_precision=high_precision,
              pallas_sampling=switch)
    want = JTerrain._use_fused(JStaticConfig(**kw))
    cfg = StaticTerrainConfig(**kw)
    assert Terrain.use_fused(cfg) == _ViewsTerrain.use_fused(cfg) == want
    assert want == (switch and grid == 16 and spherical == high_precision)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_switch")
    for att in (AttachmentConfig(**HEIGHT),
                AttachmentConfig(**{**ALBEDO, "format": AttachmentFormat.RGBA8})):
        generate_planar_dataset(TERRAIN["path"], TERRAIN["lod_count"], att, root=str(root))
    return root


@pytest.fixture
def spies(monkeypatch):
    """Each frame kernel wrapper of ``ops/kernels`` wrapped to count its
    calls (on the CPU a wrapper runs its plain version and counts no
    launch); returns (calls, the launch counters before)."""
    before = _launches()
    calls = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        wrapper = getattr(kernels, name)

        def spy(*args, _name=name, _wrapper=wrapper, **kw):
            calls[_name] += 1
            return _wrapper(*args, **kw)

        monkeypatch.setattr(kernels, name, spy)
    return calls, before


WRAPPER_FN = {name: getattr(kernels, name) for name in WRAPPERS}


def _launches():
    return {name: WRAPPER_FN[name].launches for name in WRAPPERS}


def _config(root, albedo=True):
    atts = (AttachmentConfig(**HEIGHT),)
    if albedo:
        atts += (AttachmentConfig(**{**ALBEDO, "format": AttachmentFormat.RGBA8}),)
    return TerrainConfig(model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 100.0),
                         attachments=atts, assets_root=str(root), **TERRAIN)


def _port_terrain(root, **overrides):
    terrain = Terrain(_config(root), device="cpu")
    terrain.add_view("cam", TerrainViewConfig(**VIEW_CONFIG), **VIEW_KW, **overrides)
    return terrain


# (static overrides, the wrappers a frame calls, a fused raw mesh)
SITES = {
    "default": ({}, set(), False),
    "on": (dict(pallas_sampling=True), {"mesh_fused_planar", "attach_sample_fused_packed"},
           True),
    "staged view": (dict(high_precision=True), set(), False),
    "staged view, on": (dict(high_precision=True, pallas_sampling=True),
                        {"fetch_resample_cached", "attach_sample_fused_packed"}, False),
}


@pytest.mark.parametrize("case", list(SITES))
def test_switch_reaches_every_site(dataset, spies, case):
    """Terrain.update with the unlit albedo: the mesh (fused, or staged
    with or without K6) and the attachment sampler follow the switch."""
    overrides, want, fused = SITES[case]
    calls, before = spies
    terrain = _port_terrain(dataset, **overrides)
    cfg = terrain._static_cfgs["cam"]
    assert cfg.pallas_sampling == overrides.get("pallas_sampling", False)
    terrain.set_shading(mat.albedo_material(1), lighting=False, sample_attachments=(1,))
    out = _stream(terrain, VIEW)
    assert out.tile_count > 6 and out.overflow == 0
    assert {k for k, v in calls.items() if v} == want
    assert (out.raw_mesh is not None) == fused
    assert out.colors.shape == (VIEW_CONFIG["tile_capacity"], 17, 17, 4)
    assert _launches() == before  # the CPU runs plain versions: no launch


@pytest.mark.parametrize("switch", [False, True], ids=["default", "on"])
def test_multi_view_takes_the_same_decision(dataset, spies, switch):
    """A one-view MultiViewTerrain on the CPU: the staged step by default
    (no wrapper), the fused mesh with the switch on."""
    calls, before = spies
    kw = dict(pallas_sampling=True) if switch else {}
    mvt = MultiViewTerrain(_config(dataset, albedo=False), ["cam"], devices=["cpu"],
                           view_config=TerrainViewConfig(**VIEW_CONFIG), **VIEW_KW, **kw)
    assert mvt.cfg.pallas_sampling == switch
    for _ in range(60):
        out = mvt.update({"cam": VIEW})["cam"]
        if not mvt.atlas.state.to_load and not any(a.loading for a in mvt.atlas.attachments):
            break
        time.sleep(0.01)
    out = mvt.update({"cam": VIEW})["cam"]
    assert out.tile_count > 6
    assert {k for k, v in calls.items() if v} == ({"mesh_fused_planar"} if switch else set())
    assert _launches() == before


def _keyed(out, field):
    """{(lod, x, y): the tile's rows of ``field``}: a mesh field, or the
    colours."""
    n = int(out.tile_count)
    values = np.asarray(out.colors if field == "colors" else getattr(out.mesh, field))
    return {(int(l), int(x), int(y)): values[i]
            for i, (l, (x, y)) in enumerate(zip(np.asarray(out.tiles.tile_lod[:n]),
                                                np.asarray(out.tiles.tile_xy[:n])))}


def test_default_terrain_matches_jax_terrain_on_the_same_path(dataset):
    port, jax_t = _terrains(dataset, ("planar", (np.zeros(3), 1000.0, 0.0, 100.0)),
                            [HEIGHT, ALBEDO], TERRAIN, VIEW_CONFIG, VIEW_KW)
    assert not port._static_cfgs["cam"].pallas_sampling
    assert not jax_t._static_cfgs["cam"].pallas_sampling
    port.set_shading(mat.albedo_material(1), lighting=False, sample_attachments=(1,))
    jax_t.set_shading(jmat.albedo_material(1), lighting=False, sample_attachments=(1,))
    out, jout = _stream(port, VIEW), _stream(jax_t, VIEW)
    assert out.raw_mesh is None and jout.raw_mesh is None  # both staged
    np.testing.assert_array_equal(port.last_uniform_blob("cam"),
                                  np.asarray(jax_t._last_uniforms["cam"]))
    assert out.tile_count == int(jout.tile_count) > 6
    tols = dict(heights=SAME_PATH_M, positions=SAME_PATH_M, uvs=1e-6, colors=1e-5)
    worst = {}
    for field in tols:
        got, want = _keyed(out, field), _keyed(jout, field)
        assert set(got) == set(want)
        worst[field] = max(float(np.abs(got[k] - want[k]).max()) for k in got)
    print("default Terrain, max |port - JAX| " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()))
    for field, tol in tols.items():
        assert worst[field] <= tol, (field, worst[field])
