"""The device twin of the tile-tree request scan (ops/tile_tree.py) on the CPU.

1. The cases of tests/test_ops.py::TestTileTreeScan on the port's twin:
   ``tile_tree_update`` (torch ops) against the exact f64 numpy twin
   ``tile_tree_update_host`` (slot coordinates equal, request masks agree on
   more than 99% of slots), lod 0 always requested, the sphere's shapes.
2. ``tile_tree_update`` against the JAX package's ``tile_tree_update``
   (jitted on the CPU) on the same seeded planar, sphere and ellipsoid
   frames: slot coordinates and request masks equal.

The card's run of the twin against the host twin is in
tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation
from bevy_terrain_tpu_torch.ops import tile_tree
from bevy_terrain_tpu_torch.ops.params import StaticTerrainConfig, make_frame_uniforms

PLANAR = TerrainModel.planar(np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0)
SPHERE = TerrainModel.sphere(np.zeros(3), 6.4e6, 0.0, 9000.0)


def build_frame(model, view_config, view_pos, lod_count, device="cpu"):
    """(StaticTerrainConfig, FrameUniforms on ``device``, the packed inputs)
    of a frame whose every slot reports the root tile loaded at slot 0
    (tests/test_ops.py::build_frame on the port)."""
    cfg = StaticTerrainConfig(
        spherical=model.is_spherical, side_count=model.side_count, lod_count=lod_count,
        tree_size=view_config.tree_size, grid_size=view_config.grid_size,
        refinement_count=view_config.refinement_count,
        tile_capacity=view_config.tile_capacity, origin_lod=view_config.origin_lod,
        queue_capacity=4096,
    )
    origins, vt_int, vt_frac = tile_tree.compute_view_anchors(
        model, view_pos, lod_count, view_config.tree_size)
    approx = TerrainModelApproximation.compute(
        model, view_pos, view_config.origin_lod, (model.min_height + model.max_height) / 2)
    entries = np.zeros((model.side_count, lod_count, cfg.tree_size, cfg.tree_size, 2),
                       np.int32)
    inputs = (view_pos, approx, origins, entries, vt_int, vt_frac)
    uniforms = make_frame_uniforms(model, view_pos, approx, origins, entries, vt_int, vt_frac,
                                   view_config, device=device)
    return cfg, uniforms, inputs


class TestTileTreeScan:
    def test_device_matches_host_f64(self):
        vc = TerrainViewConfig()
        view = np.array([120.0, -40.0, -300.0])
        cfg, uniforms, _ = build_frame(PLANAR, vc, view, 4)
        xy_dev, req_dev = tile_tree.tile_tree_update(uniforms, cfg)
        xy_host, req_host = tile_tree.tile_tree_update_host(PLANAR, view, uniforms, cfg)
        assert xy_dev.dtype == torch.int32 and req_dev.dtype == torch.bool
        np.testing.assert_array_equal(xy_dev.numpy(), xy_host)
        agree = np.mean(req_dev.numpy() == req_host)
        assert agree > 0.99, f"request masks agree only {agree:.4f}"

    def test_lod0_always_requested(self):
        vc = TerrainViewConfig()
        cfg, uniforms, _ = build_frame(PLANAR, vc, np.array([1e7, 1e7, 1e7]), 4)
        _, req = tile_tree.tile_tree_update(uniforms, cfg)
        assert bool(req[:, 0].all())

    def test_spherical_shapes(self):
        vc = TerrainViewConfig()
        view = SPHERE.position_local_to_world(np.array([1.0, 0.0, 0.0]), 1000.0)
        cfg, uniforms, _ = build_frame(SPHERE, vc, view, 6)
        xy, req = tile_tree.tile_tree_update(uniforms, cfg)
        assert xy.shape == (6, 6, 8, 8, 2)
        # near tiles on the viewed side must be requested at the finest lod
        assert bool(req[:, -1].any())


def _frames():
    """(name, model, view, lod count) of seeded frames over the three model
    kinds, near and far."""
    rng = np.random.default_rng(23)
    ellipsoid = TerrainModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9000.0)
    out = [("planar", PLANAR, np.array([120.0, -40.0, -300.0]), 4)]
    for i in range(3):
        out.append((f"planar{i}", PLANAR, rng.normal(0.0, 400.0, 3) + [0.0, 200.0, 0.0], 6))
    for model, name in ((SPHERE, "sphere"), (ellipsoid, "ellipsoid")):
        for i, altitude in enumerate((1000.0, 60_000.0, 2e6)):
            d = rng.normal(size=3)
            out.append((f"{name}{i}", model,
                        model.surface_position(d / np.linalg.norm(d), altitude), 8))
    return out


FRAMES = _frames()


@pytest.mark.parametrize("frame", range(len(FRAMES)), ids=[f[0] for f in FRAMES])
def test_matches_the_jax_twin(frame):
    """The port's twin and the JAX package's on the same packed frame give
    the same slot coordinates and request masks."""
    from bevy_terrain_tpu import TerrainViewConfig as JViewConfig
    from bevy_terrain_tpu.math import TerrainModel as JModel
    from bevy_terrain_tpu.math import TerrainModelApproximation as JApprox
    from bevy_terrain_tpu.ops import tile_tree as jtile_tree
    from bevy_terrain_tpu.ops.params import StaticTerrainConfig as JStaticConfig
    from bevy_terrain_tpu.ops.params import make_frame_uniforms as jmake

    _, model, view, lods = FRAMES[frame]
    vc = TerrainViewConfig()
    cfg, uniforms, (_, approx, origins, entries, vt_int, vt_frac) = build_frame(
        model, vc, view, lods)
    if model.kind == "planar":
        jmodel = JModel.planar(model.translation, 1000.0, 0.0, 250.0)
    elif model.kind == "spherical":
        jmodel = JModel.sphere(model.translation, 6.4e6, 0.0, 9000.0)
    else:
        jmodel = JModel.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9000.0)
    np.testing.assert_array_equal(np.asarray(jmodel.world_from_local), model.world_from_local)
    japprox = JApprox(**{f: getattr(approx, f) for f in approx.__dataclass_fields__})
    juniforms = jmake(jmodel, view, japprox, origins, entries, vt_int, vt_frac, JViewConfig())
    jcfg = JStaticConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    jxy, jreq = jax.jit(jtile_tree.tile_tree_update, static_argnums=1)(juniforms, jcfg)
    xy, req = tile_tree.tile_tree_update(uniforms, cfg)
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(req.numpy(), np.asarray(jreq))
    assert 0 < int(req.sum()) < req.numel()  # the frame requests some slots, not all
