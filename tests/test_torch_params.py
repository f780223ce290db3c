"""Packed frame uniforms: the torch package against the JAX package.

The same frame packs to a bit-identical int32 blob in both packages, and
both unpack it to exactly equal fields of the same dtypes.
"""

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevy_terrain_tpu.config import TerrainViewConfig as JViewConfig
from bevy_terrain_tpu.math import TerrainModel as JModel
from bevy_terrain_tpu.math import TerrainModelApproximation as JApprox
from bevy_terrain_tpu.math import frustum as jfrustum
from bevy_terrain_tpu.ops import params as jparams
from bevy_terrain_tpu.ops import tile_tree as jtile_tree
from bevy_terrain_tpu_torch.config import TerrainViewConfig
from bevy_terrain_tpu_torch.math import TerrainModel, TerrainModelApproximation
from bevy_terrain_tpu_torch.math import frustum
from bevy_terrain_tpu_torch.ops import params
from bevy_terrain_tpu_torch.ops import tile_tree

LODS = 5
FRAMES = {
    # (model args, view, camera target or None, approximate height)
    "bench_culled": ((np.zeros(3), 8000.0, 0.0, 250.0), [240.0, 120.0, -160.0],
                     [1240.0, 80.0, 140.0], 125.0),
    "offset_plain": ((np.array([0.0, -100.0, 0.0]), 1000.0, 0.0, 250.0),
                     [-380.0, -70.0, 310.0], None, 31.5),
}


def _blobs(name, fn="pack_frame_uniforms"):
    """The frame packed by each package from its own host modules (or, with
    ``fn="make_frame_uniforms"``, assembled into each package's
    FrameUniforms, the port's on the CPU): (JAX product, port product)."""
    (pos, side, hmin, hmax), view, target, height = FRAMES[name]
    view = np.asarray(view, np.float64)
    rng = np.random.default_rng(7)
    entries = rng.integers(-1, 1024, (1, LODS, 8, 8, 2)).astype(np.int32)
    out = []
    for Model, Approx, ViewConfig, anchors, fr, pack in (
        (JModel, JApprox, JViewConfig, jtile_tree.compute_view_anchors, jfrustum,
         getattr(jparams, fn)),
        (TerrainModel, TerrainModelApproximation, TerrainViewConfig,
         tile_tree.compute_view_anchors, frustum,
         functools.partial(params.make_frame_uniforms, device="cpu")
         if fn == "make_frame_uniforms" else params.pack_frame_uniforms),
    ):
        model = Model.planar(pos, side, hmin, hmax)
        vc = ViewConfig(tile_capacity=512)
        vp = None if target is None else fr.view_projection(
            view, np.asarray(target, np.float64), np.pi / 3, 16 / 9)
        origins, vt_int, vt_frac = anchors(model, view, LODS, vc.tree_size)
        approx = Approx.compute(model, view, vc.origin_lod, height)
        out.append(pack(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                        view_proj=vp))
    return out


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_pack_is_bit_identical(name):
    jblob, tblob = _blobs(name)
    assert jblob.dtype == tblob.dtype == np.int32
    np.testing.assert_array_equal(jblob, tblob)
    assert params.packed_f32_count(1, LODS) == jparams.packed_f32_count(1, LODS)


def _flat_fields(u, prefix=""):
    for f in dataclasses.fields(u):
        v = getattr(u, f.name)
        if dataclasses.is_dataclass(v):
            yield from _flat_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def _assert_fields_exact(ju, tu):
    jf, tf = dict(_flat_fields(ju)), dict(_flat_fields(tu))
    assert jf.keys() == tf.keys()
    for key, jv in jf.items():
        jv = np.asarray(jv)
        tv = tf[key].numpy()
        assert tv.dtype == jv.dtype, (key, tv.dtype, jv.dtype)
        assert tv.shape == jv.shape, (key, tv.shape, jv.shape)
        np.testing.assert_array_equal(tv, jv, err_msg=key)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_unpack_fields_exact(name):
    _, blob = _blobs(name)
    _assert_fields_exact(jparams.unpack_frame_uniforms(jnp.asarray(blob), 1, LODS, 8),
                         params.unpack_frame_uniforms(torch.from_numpy(blob), 1, LODS, 8))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_make_frame_uniforms_fields_exact(name):
    """The one-call assembly (the per-vertex path's in the JAX pipeline)
    gives the JAX function's fields exactly."""
    _assert_fields_exact(*_blobs(name, "make_frame_uniforms"))


def test_make_frame_uniforms_defaults_to_the_card():
    """Like the JAX function, which runs on the default accelerator, the
    port's assembles its uniforms on the card unless the caller asks for
    the CPU."""
    assert inspect.signature(params.make_frame_uniforms).parameters["device"].default == "cuda"


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid"])
def test_make_frame_uniforms_on_the_cpu_matches_jax_on_a_planet(kind):
    """A planet's frame (Taylor coefficients, cube-sphere origins, a culled
    camera at 60 km) assembled with ``device="cpu"``: the JAX function's
    fields exactly."""
    rng = np.random.default_rng(9)
    entries = rng.integers(-1, 512, (6, LODS, 8, 8, 2)).astype(np.int32)
    out = []
    for Model, Approx, ViewConfig, anchors, fr, make in (
        (JModel, JApprox, JViewConfig, jtile_tree.compute_view_anchors, jfrustum,
         jparams.make_frame_uniforms),
        (TerrainModel, TerrainModelApproximation, TerrainViewConfig,
         tile_tree.compute_view_anchors, frustum,
         functools.partial(params.make_frame_uniforms, device="cpu")),
    ):
        if kind == "sphere":
            model = Model.sphere(np.zeros(3), 6.371e6, 0.0, 9000.0)
        else:
            model = Model.ellipsoid(np.zeros(3), 6_378_137.0, 6_356_752.3, -11_000.0, 9000.0)
        vc = ViewConfig(tile_capacity=512)
        view = model.surface_position(np.array([0.2, 0.3, 6.371e6]), 60_000.0)
        vp = fr.view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
        origins, vt_int, vt_frac = anchors(model, view, LODS, vc.tree_size)
        approx = Approx.compute(model, view, vc.origin_lod, 4500.0)
        out.append(make(model, view, approx, origins, entries, vt_int, vt_frac, vc,
                        view_proj=vp))
    _assert_fields_exact(*out)
    assert out[1].view_world_position.device.type == "cpu"


def test_unpack_rejects_non_int32():
    with pytest.raises(ValueError):
        params.unpack_frame_uniforms(torch.zeros(10, dtype=torch.int64), 1, LODS, 8)
