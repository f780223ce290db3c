"""The pipeline features around the frame: the torch package's ``Terrain`` on
the CPU against the JAX package's, on the same files.

A planar 1000 m terrain (3 lods of 512^2 R16 height tiles, capacity 128,
``morph_distance`` 2 so that the tile count follows the camera's height: 4
tiles from 800 m, 64 from 150 m; ``blend_per_vertex``, the fused kernel's
blend) is streamed by both packages, each on its default path on the CPU:
the staged mesh (``pallas_sampling`` off). Meshes agree per tile within
:data:`SAME_PATH_M`; freeze also runs on a port view with the switch on
(the fused kernel's plain version) against the same JAX frames within the
fused-vs-staged 1e-3 m. The cases of tests/test_pipeline.py:429-503
and tests/test_material.py:507-575, each held to the JAX ``Terrain`` as
well as to its own claim:

* adaptive capacity: the ladder steps down under a high camera and the
  frame keeps its tile set, its shapes follow the rung;
* the same-frame overflow guard: a teleport to a low camera overflows the
  settled rung, the frame is dispatched again and drops no geometry;
* freeze: the tile list stays pinned while the mesh follows the camera;
* ``tune_view``: a distance change alters the next frame's tile count, a
  grid-size change rebuilds the view (9x9 vertex grids through the staged
  mesh) and back;
* ``set_debug``: the specialization flags rebuild the static configs and
  the debug view's colours match;
* the multi-tap gradient sampler (``grad_tile_span``,
  ``sample_attachment_vertices_grad``) against the JAX functions on
  small_frame's mesh, from a grazing camera.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.debug import DebugTerrain as JDebugTerrain
from bevy_terrain_tpu.ops import patch_sampling as jps
from bevy_terrain_tpu.ops.params import unpack_frame_uniforms as junpack
from bevy_terrain_tpu_torch.config import AttachmentConfig
from bevy_terrain_tpu_torch.debug import ApproachCamera, DebugTerrain, FlyCamera, OrbitCamera
from bevy_terrain_tpu_torch.ops import meshgen, refinement
from bevy_terrain_tpu_torch.ops import patch_sampling as ps
from bevy_terrain_tpu_torch.ops.params import unpack_frame_uniforms
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from tests.test_torch_attach_sampling import packed_words
from tests.test_torch_material import _jax_cfg, _jax_mesh, _jax_tiles
from tests.test_torch_patch_sampling import LODS, small_frame
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_staged_pipeline import _stream, _terrains

ATT = dict(name="height", texture_size=512, border_size=2, mip_level_count=4)
TERRAIN = dict(lod_count=3, atlas_size=32, path="terrains/features")
VIEW_CONFIG = dict(tile_capacity=128, morph_distance=2.0, blend_distance=1.5)
VIEW_KW = dict(queue_capacity=512, blend_per_vertex=True)
HIGH = np.array([0.0, 800.0, 0.0])
LOW = np.array([0.0, 150.0, 0.0])
VIEW = np.array([-120.0, 150.0, 160.0])
# the port's staged mesh against the JAX package's, per tile: measured at
# most 6.5e-5 m over these cases (a few f32 ulps of the 100 m range; 6.1e-5
# m after the structural tune_view, which the fused-vs-staged paths put
# 1.56 m apart); the bound keeps a margin of 3, a fifth of the reference's
# 1e-3 m (tests/test_goldens.py:136-138)
SAME_PATH_M = 2e-4
# the fused kernel's mesh against the JAX package's staged one
# (test_torch_pipeline.py's bound; measured 6.3e-5 m)
FUSED_VS_STAGED_M = 1e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_features")
    generate_planar_dataset(TERRAIN["path"], 3, AttachmentConfig(**ATT), root=str(root))
    return root


def _both(root, **port_kw):
    return _terrains(root, ("planar", (np.zeros(3), 1000.0, 0.0, 100.0)), [ATT], TERRAIN,
                     VIEW_CONFIG, VIEW_KW, port_kw)


@pytest.fixture(scope="module")
def terrains(root):
    return _both(root)


@pytest.fixture(scope="module")
def fused_port(root):
    """A port Terrain with ``pallas_sampling=True``: the fused kernel."""
    return _both(root, pallas_sampling=True)[0]


def _tile_set(out):
    n = int(out.tile_count)
    return {(int(l), int(x), int(y)) for l, (x, y) in zip(np.asarray(out.tiles.tile_lod[:n]),
                                                          np.asarray(out.tiles.tile_xy[:n]))}


def _keyed(out, field):
    n = int(out.tile_count)
    values = np.asarray(getattr(out.mesh, field))
    return {(int(l), int(x), int(y)): values[i]
            for i, (l, (x, y)) in enumerate(zip(np.asarray(out.tiles.tile_lod[:n]),
                                                np.asarray(out.tiles.tile_xy[:n])))}


def _assert_same_mesh(out, jout, tol=SAME_PATH_M):
    """Per tile key: heights and positions within ``tol`` m."""
    assert _tile_set(out) == _tile_set(jout)
    for field in ("heights", "positions"):
        got, want = _keyed(out, field), _keyed(jout, field)
        print(f"max |port - JAX| {field} "
              f"{max(float(np.abs(got[k] - want[k]).max()) for k in got):.3e} (tol {tol})")
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                       err_msg=f"{field} {key}")


def test_ladder_adapts_and_outputs_match(terrains):
    """The frame runs at the smallest rung covering 2x the previous frame's
    tile count, in both packages; tile set and mesh as at full capacity."""
    for t in terrains:
        _stream(t, HIGH)
    full = [t.update({"cam": HIGH})["cam"] for t in terrains]
    assert _tile_set(full[0]) == _tile_set(full[1]) and full[0].tile_count > 0
    for t in terrains:
        t.enable_adaptive_capacity("cam", ladder=[32, 64, 128])
    try:
        # frame 1 runs at full capacity (no count yet), then adapts
        outs = [[t.update({"cam": HIGH})["cam"] for _ in range(3)] for t in terrains]
        port, jax_t = terrains
        ad, jad = port._adaptive["cam"], jax_t._adaptive["cam"]
        assert ad["ladder"] == jad["ladder"] == [32, 64, 128]
        assert ad["capacity"] == jad["capacity"] < 128
        assert ad["last_count"] == jad["last_count"] == full[0].tile_count
        last, jlast = outs[0][-1], outs[1][-1]
        assert last.overflow == 0 and _tile_set(last) == _tile_set(full[0])
        # shapes follow the adapted capacity, and frame_inputs names it
        assert last.mesh.heights.shape[0] == ad["capacity"] == jlast.mesh.heights.shape[0]
        assert port.frame_inputs("cam")[1].tile_capacity == ad["capacity"]
        assert port._static_cfgs["cam"].tile_capacity == 128
        _assert_same_mesh(last, jlast)
        assert port.overflow_redispatches == jax_t.overflow_redispatches
    finally:
        for t in terrains:
            t.disable_adaptive_capacity("cam")
    assert terrains[0].update({"cam": HIGH})["cam"].mesh.heights.shape[0] == 128


def test_teleport_spike_no_dropped_geometry(terrains):
    """A teleport to a low camera overflows the settled rung; the guard
    reads the overflow that frame and dispatches again at the next rung."""
    counts = []
    for t in terrains:
        _stream(t, HIGH)
        c_high = int(t.update({"cam": HIGH})["cam"].tile_count)
        c_low = int(_stream(t, LOW).tile_count)
        counts.append((c_high, c_low))
        _stream(t, HIGH)
    assert counts[0] == counts[1]
    c_high, c_low = counts[0]
    # the teleport is a real spike that overflows the settled-high rung
    rung_high = 1 << math.ceil(math.log2(max(c_high * 2, 2)))
    assert rung_high < c_low <= 128, counts
    results = []
    for t in terrains:
        t.enable_adaptive_capacity("cam", ladder=[rung_high, 128], headroom=2.0)
        try:
            t.update({"cam": HIGH})  # runs at full capacity, counts
            t.update({"cam": HIGH})  # settles to rung_high
            assert t._adaptive["cam"]["capacity"] == rung_high
            before, checks = t.overflow_redispatches, t.overflow_checks
            out = t.update({"cam": LOW})["cam"]  # teleport
            assert int(out.overflow) == 0 and int(out.tile_count) == c_low
            assert t.overflow_redispatches == before + 1
            results.append((out, t.overflow_checks - checks, t._adaptive["cam"]["capacity"]))
            # a steady camera pays no check
            checks = t.overflow_checks
            t.update({"cam": LOW})
            assert t.overflow_checks == checks
        finally:
            t.disable_adaptive_capacity("cam")
    (out, checks, cap), (jout, jchecks, jcap) = results
    assert checks == jchecks and cap == jcap == 128
    assert out.mesh.heights.shape[0] == 128
    _assert_same_mesh(out, jout)


@pytest.mark.parametrize("path", ["default", "fused"])
def test_freeze_pins_tile_list(request, terrains, path):
    """Frozen, the tile SET stays pinned under a moved camera while the
    mesh morphs from the new camera; unfrozen, refinement resumes. The
    frozen frame takes the view's path: the staged mesh by default, the
    fused kernel on the pinned list with the switch on."""
    port = terrains[0] if path == "default" else request.getfixturevalue("fused_port")
    moved = VIEW + np.array([300.0, 900.0, 200.0])
    outs = []
    for t, debug in zip((port, terrains[1]), (DebugTerrain, JDebugTerrain)):
        _stream(t, VIEW)
        t.set_debug(debug(freeze=True))
        out1 = t.update({"cam": VIEW})["cam"]
        out2 = t.update({"cam": moved})["cam"]
        assert _tile_set(out2) == _tile_set(out1) and out2.tile_count == out1.tile_count
        uv1, uv2 = _keyed(out1, "uvs"), _keyed(out2, "uvs")
        assert max(float(np.abs(uv1[k] - uv2[k]).max()) for k in uv1) > 1e-4
        t.set_debug(debug(freeze=False))
        out3 = t.update({"cam": moved})["cam"]
        assert _tile_set(out3) != _tile_set(out1)
        t.set_debug(None)
        outs.append((out1, out2, out3))
    for out, jout in zip(*outs):
        _assert_same_mesh(out, jout, SAME_PATH_M if path == "default" else FUSED_VS_STAGED_M)
    assert port.debug is None and not port._frozen_tiles
    frozen = outs[0][1].raw_mesh
    assert (frozen is None) if path == "default" else frozen.shape[1:] == (6, 17, 17)


def test_set_debug_respecializes(terrains):
    """The specialization toggles reach every view's static config, and the
    debug view's colours come out as the JAX package's."""
    outs = []
    for t, debug in zip(terrains, (DebugTerrain, JDebugTerrain)):
        _stream(t, VIEW)
        t.set_debug(debug(morph=False, blend=False, tile_tree_lod=True, show_data_lod=True,
                          show_pixels=True, lighting=False, test2=True))
        cfg = t._static_cfgs["cam"]
        assert (cfg.morph, cfg.blend, cfg.tile_tree_lod, cfg.test2) == (False, False, True, True)
        assert t._shade_opts[:2] == (False, ("data_lod", "pixels"))
        out = t.update({"cam": VIEW})["cam"]
        # unmorphed: every vertex on its grid position
        grid = np.arange(17, dtype=np.float32) / 16.0
        uvs = np.asarray(out.mesh.uvs)[:int(out.tile_count)]
        np.testing.assert_array_equal(uvs[..., 0], np.broadcast_to(grid, uvs.shape[:-1]))
        t.set_debug(debug())
        assert t._static_cfgs["cam"].morph and not t._static_cfgs["cam"].tile_tree_lod
        t.set_shading(enabled=False)
        t.set_debug(None)
        outs.append(out)
    out, jout = outs
    assert _tile_set(out) == _tile_set(jout)
    got = {k: np.asarray(out.colors)[i] for i, k in enumerate(_ordered_keys(out))}
    want = {k: np.asarray(jout.colors)[i] for i, k in enumerate(_ordered_keys(jout))}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=str(key))
    assert np.asarray(out.colors).std() > 0.0


def _ordered_keys(out):
    n = int(out.tile_count)
    return [(int(l), int(x), int(y)) for l, (x, y) in zip(np.asarray(out.tiles.tile_lod[:n]),
                                                          np.asarray(out.tiles.tile_xy[:n]))]


def test_remove_view_drops_every_state(terrains):
    port = terrains[0]
    from bevy_terrain_tpu_torch.config import TerrainViewConfig

    port.add_view("second", TerrainViewConfig(**VIEW_CONFIG), queue_capacity=512)
    port.enable_adaptive_capacity("second", ladder=[64, 128])
    port.update({"second": VIEW})
    assert "second" in port._last_frame_cfgs and "second" in port._adaptive
    port.remove_view("second")
    for state in (port.tile_trees, port._static_cfgs, port._adaptive, port._last_blobs,
                  port._last_frame_cfgs, port._last_view_pos, port._frozen_tiles):
        assert "second" not in state


def test_tune_view_distances_and_grid_size(terrains):
    """Runs last of the pipeline cases: the structural change rebuilds the
    view without ``blend_per_vertex``."""
    outs = []
    for t in terrains:
        _stream(t, VIEW)
        t.tune_view("cam", morph_distance=1.0)
        coarse = t.update({"cam": VIEW})["cam"]
        t.tune_view("cam", morph_distance=2.0)
        fine = t.update({"cam": VIEW})["cam"]
        assert int(coarse.overflow) == 0 and int(fine.overflow) == 0
        assert int(coarse.tile_count) < int(fine.tile_count)
        # structural: the view is rebuilt, its tiles re-requested
        t.tune_view("cam", grid_size=8)
        small = _stream(t, VIEW)
        assert small.mesh.heights.shape[1:] == (9, 9)
        t.tune_view("cam", grid_size=16)
        back = _stream(t, VIEW)
        assert back.mesh.heights.shape[1:] == (17, 17)
        outs.append((coarse, fine, small, back))
    port = terrains[0]
    assert port.view_configs["cam"].grid_size == 16
    cfg = port._static_cfgs["cam"]
    assert cfg.queue_capacity == 512
    # the rebuilt view keeps its specialization flags but neither
    # ``blend_per_vertex`` nor ``pallas_sampling`` (in both packages): back
    # at grid size 16 it takes the default path, on the CPU the staged
    # mesh blending at the tile centre in both packages
    assert not cfg.blend_per_vertex and not cfg.pallas_sampling
    assert outs[0][2].raw_mesh is None and outs[0][3].raw_mesh is None
    for out, jout in zip(*outs):
        _assert_same_mesh(out, jout)


def test_debug_cameras_are_the_jax_packages():
    from bevy_terrain_tpu import debug as jdebug

    for a, b in ((OrbitCamera(np.zeros(3), 500.0, 80.0, 20.0),
                  jdebug.OrbitCamera(np.zeros(3), 500.0, 80.0, 20.0)),
                 (ApproachCamera(np.zeros(3), 5000.0, 50.0),
                  jdebug.ApproachCamera(np.zeros(3), 5000.0, 50.0))):
        np.testing.assert_array_equal(np.array(a.path(7)), np.array(b.path(7)))
    fly, jfly = FlyCamera(), jdebug.FlyCamera()
    for _ in range(5):
        p = fly.update(0.016, move=(0.2, 0.1, 1.0), look=(0.3, -0.1), accelerate=0.5)
        jp = jfly.update(0.016, move=(0.2, 0.1, 1.0), look=(0.3, -0.1), accelerate=0.5)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(fly.view_projection(), jfly.view_projection())
    d = DebugTerrain(show_data_lod=True, show_pixels=True, tile_tree_lod=True)
    jd = JDebugTerrain(show_data_lod=True, show_pixels=True, tile_tree_lod=True)
    assert d.debug_view == jd.debug_view == ("data_lod", "pixels")
    assert d.static_overrides() == jd.static_overrides()


# -- the gradient sampler -------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "planar"])
def test_gradient_sampler_matches_jax(packed):
    """small_frame's fused mesh seen from a grazing camera (the footprint
    stretches along the view's surface projection): the per-tile span and
    the 4-tap sample of a random attachment, packed Rgba8 or one raw
    channel, against the JAX functions within 1e-5."""
    blob, blocks, cfg, _, plan, jplan = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    raw, tiles = meshgen.generate_mesh_fused(refinement.refine_tiles(u, cfg),
                                             torch.from_numpy(blocks), u, cfg, plan, 65535.0)
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    jmesh, jtiles, jcfg = _jax_mesh(mesh), _jax_tiles(tiles), _jax_cfg(cfg)
    span = ps.grad_tile_span(mesh, u, cfg)
    jspan = np.asarray(jax.jit(lambda jmesh, ju: jps.grad_tile_span(jmesh, ju, jcfg))(jmesh, ju))
    n = int(tiles.tile_count)
    np.testing.assert_allclose(span.numpy()[:n], jspan[:n], rtol=0, atol=1e-6)
    # anisotropy above 1 somewhere: spans longer than one half-grid step
    assert float(torch.linalg.vector_norm(span[:n], dim=-1).max()) > 1.0 / 32.0
    if packed:
        arrays, kw = [packed_words(blocks.shape, 4, 8, 41)], dict(packed_channels=4,
                                                                  packed_bits=8)
        full = 255.0
    else:
        arrays, kw, full = [blocks], {}, 65535.0
    got = ps.sample_attachment_vertices_grad(
        [torch.from_numpy(a) for a in arrays], tiles, mesh.uvs, mesh, u, cfg, plan, full,
        taps=4, **kw).numpy()
    want = np.asarray(jax.jit(lambda arrays, jtiles, jmesh, ju: jps.sample_attachment_vertices_grad(
        arrays, jtiles, jmesh.uvs, jmesh, ju, jcfg, jplan, full, taps=4, **kw))(
            [jnp.asarray(a) for a in arrays], jtiles, jmesh, ju))
    assert got.shape == want.shape == (cfg.tile_capacity, 17, 17, 4 if packed else 1)
    err = float(np.abs(got[:n] - want[:n]).max())
    print(f"gradient sampler ({'packed' if packed else 'planar'}): max |port - JAX| {err:.3e}")
    assert err <= 1e-5
    one = ps.sample_attachment_vertices(
        [torch.from_numpy(a) for a in arrays], tiles, mesh.uvs, u, cfg, plan, full, **kw).numpy()
    assert 1e-3 < float(np.abs(got[:n] - one[:n]).max()) < 0.6  # a filter, not a copy


@pytest.mark.parametrize("plan_matches_frame", [True, False])
def test_gradient_sampler_takes_plan_matches_frame(plan_matches_frame):
    """``sample_attachment_vertices_grad`` takes the JAX function's
    ``plan_matches_frame`` keyword (``Terrain._sample_grid`` passes it) and,
    like it, samples the same either way: a raw height attachment at 2 taps
    against the JAX function called with the same keyword within 1e-5, and
    against the port's own call without it bit for bit."""
    blob, blocks, cfg, _, plan, jplan = small_frame()
    u = unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8)
    ju = junpack(jnp.asarray(blob), 1, LODS, 8)
    raw, tiles = meshgen.generate_mesh_fused(refinement.refine_tiles(u, cfg),
                                             torch.from_numpy(blocks), u, cfg, plan, 65535.0)
    mesh = meshgen.fused_to_grid(raw, tiles, cfg)
    jmesh, jtiles, jcfg = _jax_mesh(mesh), _jax_tiles(tiles), _jax_cfg(cfg)
    args = ([torch.from_numpy(blocks)], tiles, mesh.uvs, mesh, u, cfg, plan, 65535.0)
    got = ps.sample_attachment_vertices_grad(*args, taps=2,
                                             plan_matches_frame=plan_matches_frame).numpy()
    want = np.asarray(jax.jit(lambda blocks, jtiles, jmesh, ju: jps.sample_attachment_vertices_grad(
        [blocks], jtiles, jmesh.uvs, jmesh, ju, jcfg, jplan, 65535.0, taps=2,
        plan_matches_frame=plan_matches_frame))(jnp.asarray(blocks), jtiles, jmesh, ju))
    n = int(tiles.tile_count)
    assert got.shape == want.shape == (cfg.tile_capacity, 17, 17, 1)
    assert float(np.abs(got[:n] - want[:n]).max()) <= 1e-5
    np.testing.assert_array_equal(got, ps.sample_attachment_vertices_grad(*args, taps=2).numpy())
