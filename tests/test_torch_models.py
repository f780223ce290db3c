"""The port's presets (``bevy_terrain_tpu_torch.models``) against the JAX
package's, field by field, exactly: the attachment configs, the view
config, the terrain configs and their models' numeric fields. The deep
streaming view drives a port ``TileTree`` whose request scan equals the
JAX ``TileTree``'s over three camera positions in turn, exactly: the
requests in order, the releases as a set (the JAX package's native scan
lists them in its own order), the slot coordinates and flags."""

import dataclasses

import numpy as np
import pytest

import bevy_terrain_tpu.models as jmodels
import bevy_terrain_tpu_torch.models as models
from bevy_terrain_tpu.terrain_data import TileAtlas as JTileAtlas
from bevy_terrain_tpu.terrain_data.tile_tree import TileTree as JTileTree
from bevy_terrain_tpu_torch.terrain_data import TileAtlas
from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)


def _fields(x):
    """A config or model as plain values: enums by name, arrays as
    float64 lists, nested dataclasses recursively."""
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [_fields(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tolist())
    if hasattr(x, "name") and hasattr(x, "value") and type(x).__module__.endswith("config"):
        return ("enum", type(x).__name__, x.name, x.value)
    return x


PRESETS = [
    ("height_attachment", {}), ("height_attachment", dict(texture_size=256, mips=3)),
    ("albedo_attachment", {}), ("albedo_attachment", dict(texture_size=128, mips=2)),
    ("planar_demo", {}), ("planar_demo", dict(path="p", assets_root="r")),
    ("earth", {}), ("earth", dict(lod_count=13)),
    ("earth_ellipsoid", {}), ("earth_ellipsoid", dict(lod_count=10)),
    ("streaming_flythrough_view", {}), ("streaming_flythrough_view", dict(tile_capacity=2048)),
]


@pytest.mark.parametrize("name,kw", PRESETS, ids=[f"{n}-{len(k)}" for n, k in PRESETS])
def test_preset_equals_the_jax_preset(name, kw):
    got, want = getattr(models, name)(**kw), getattr(jmodels, name)(**kw)
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)


def test_presets_are_the_jax_modules_names():
    public = {n for n in dir(jmodels) if not n.startswith("_") and callable(getattr(jmodels, n))
              and getattr(jmodels, n).__module__ == jmodels.__name__}
    assert public == {n for n, _ in PRESETS}
    assert all(getattr(models, n).__module__ == models.__name__ for n in public)


def _flythrough_config(pkg, root):
    """tools/flythrough_bench.py's terrain: 40 km planar, 12 geometry lods,
    a 1024-slot atlas (no tile on disk: the scan does not read them)."""
    att = pkg.AttachmentConfig(name="height", texture_size=512, border_size=2,
                               mip_level_count=4, format=pkg.AttachmentFormat.R16)
    return pkg.TerrainConfig(lod_count=12, model=pkg.TerrainModel.planar(
        np.zeros(3), 40_000.0, 0.0, 2500.0), atlas_size=1024, path="terrains/fly",
        attachments=(att,), assets_root=str(root))


def _coords(tiles):
    return [(c.side, c.lod, c.x, c.y) for c in tiles]


def test_streaming_view_request_scan_equals_jax(tmp_path):
    import bevy_terrain_tpu as jbt
    import bevy_terrain_tpu_torch as bt

    tree = TileTree(TileAtlas(_flythrough_config(bt, tmp_path), "cpu"),
                    models.streaming_flythrough_view())
    jtree = JTileTree(JTileAtlas(_flythrough_config(jbt, tmp_path)),
                      jmodels.streaming_flythrough_view())
    # the flythrough's first, middle and last camera positions
    for view in ([-14_000.0, 12_060.0, 10_000.0], [-2_000.0, 3_060.0, 2_000.0],
                 [10_000.0, 60.0, -6_000.0]):
        tree.compute_requests(np.array(view))
        jtree.compute_requests(np.array(view))
        assert _coords(tree.requested_tiles) == _coords(jtree.requested_tiles)
        # the native scan of the JAX package releases in its own order
        assert sorted(_coords(tree.released_tiles)) == sorted(_coords(jtree.released_tiles))
        assert np.array_equal(tree.tile_xy, np.asarray(jtree.tile_xy))
        assert np.array_equal(tree.tile_requested, np.asarray(jtree.tile_requested))
        assert tree.requested_tiles  # each move asks for tiles
