"""The study tool twins (tools_torch/) with ``--cpu``.

Each runs on the port at a shrunk size and prints its rows and keys:

* earth_kernel_ablation and morph_gating_analysis: the Earth frame at
  capacity 256 (queue 512), every VARIANT a row (one timed call, host
  wall on the CPU, named so); the morph-gating counts equal the same
  computation (the twin's ``analyse``) over the JAX package's ``Terrain``
  on the same shrunk scene, its tile list in the same quad-sorted order;
* material_kernel_ablation: the bench scene's atlas cut to 8 slots and its
  capacity to 256, unshaded and ``--shade``;
* raster_ablation: the bench scene at capacity 256, a 128x96 image, every
  stage a row, the dropped candidates counted;
* rust_interchange ``--check``: every one of the 29 committed hashes of
  tools/interchange_expected.json it makes, with the native runtime and
  with ``BT_DISABLE_NATIVE=1`` (the numpy scan), the five request-scan
  CSVs among them; without PIL the PNG is named "not made" and the other
  28 reproduced; ``--freeze`` writes only the path it is given;
* make_goldens ``--check``: tests/goldens/ reproduced (node lists exactly,
  the planar mesh at tests/test_goldens.py's CPU tolerance, the Earth mesh
  at f32 ulps), written into a temporary directory only.
"""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

import tools_torch.scenes as scenes
from bevy_terrain_tpu_torch import native
from bevy_terrain_tpu_torch.utils import timing
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tools_torch import (
    earth_kernel_ablation, make_goldens, material_kernel_ablation, morph_gating_analysis,
    raster_ablation, rust_interchange,
)

ROOT = Path(__file__).resolve().parent.parent
EARTH = ["--cpu", "--capacity", "256", "--queue", "512"]


def _one_call(fn, *args, label="bench", on_card=True):
    assert not on_card  # --cpu: the tools never ask the CPU for a device time
    return timing.benchmark(fn, *args, n=1, warmup=0)["min_ms"], "CPU wall"


@pytest.fixture
def one_timed_call(monkeypatch):
    monkeypatch.setattr(scenes, "time_ms", _one_call)


def test_earth_kernel_ablation_prints_its_rows(capsys, one_timed_call):
    got = earth_kernel_ablation.main(EARTH)
    out = capsys.readouterr().out
    print(out)
    names = [name for name, _ in earth_kernel_ablation.VARIANTS]
    assert list(got["ms"]) == names and got["timing"] == "CPU wall"
    assert got["tiles"] == 256 and all(v > 0 for v in got["ms"].values())
    assert "attribution (deltas vs full, CPU wall):" in out
    for name in names:
        assert f"{name:16s}" in out


@pytest.mark.parametrize("shade", [False, True], ids=["albedo", "shaded"])
def test_material_kernel_ablation_prints_its_rows(monkeypatch, capsys, one_timed_call, shade):
    monkeypatch.setattr(scenes, "ATLAS_SLOTS", 8)
    got = material_kernel_ablation.main(["--cpu", "--capacity", "256", "--queue", "256"]
                                        + (["--shade"] if shade else []))
    out = capsys.readouterr().out
    print(out)
    names = [name for name, _ in material_kernel_ablation.VARIANTS]
    assert list(got["ms"]) == names and got["shade"] == shade
    assert got["timing"] == "CPU wall" and got["tiles"] > 0
    assert "attribution (deltas vs merged_full" in out


def test_raster_ablation_prints_its_rows(monkeypatch, capsys, one_timed_call):
    monkeypatch.setattr(scenes, "ATLAS_SLOTS", 8)
    got = raster_ablation.main(["--cpu", "--size", "128x96", "--capacity", "256",
                                "--bin-cap", "64"])
    out = capsys.readouterr().out
    print(out)
    stages = ["project", "sort", "sort_packed", "table", "scan", "resolve", "full"]
    assert list(got["ms"]) == stages and got["timing"] == "CPU wall"
    assert got["bins"] == 4 * 3 and got["caps"][0] == 64
    assert got["dropped"] > 0  # a cap of 64 drops candidates on this frame
    assert f"dropped candidates (bin_overflow) {got['dropped']} at bin_cap 64" in out
    assert raster_ablation.size_arg("1920x1080") == (1920, 1080)
    assert raster_ablation.size_arg("64") == (64, 64)


def _jax_earth_tiles(capacity: int, queue: int):
    """The JAX package's Terrain on the same shrunk Earth scene, settled:
    (side, lod, xy, count) of its frame's tile list (quad-sorted by its
    staged mesh path), and its model."""
    from bevy_terrain_tpu import (
        Preprocessor, SphericalDataset, Terrain, TerrainConfig, TerrainModel, TerrainViewConfig,
    )
    from bevy_terrain_tpu.formats.tiff import array_to_source
    from bevy_terrain_tpu.math.coordinate import local_position_from_side_uv
    from bevy_terrain_tpu.math.frustum import view_projection
    from bevy_terrain_tpu.models import height_attachment
    from bevy_terrain_tpu.terrain_data import TileAtlas
    from tools_torch.earth_frame_bench import DATA_LODS, LODS, MAX_HEIGHT, RADIUS

    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="jax_earth_"))
    n = 256
    uv = (np.arange(n) + 0.5) / n
    uu, vv = np.meshgrid(uv, uv, indexing="xy")
    grid_uv = np.stack([uu, vv], axis=-1)
    paths = []
    for side in range(6):
        p = local_position_from_side_uv(side, grid_uv)
        path = tmp / f"f{side}.png"
        array_to_source(np.clip(0.5 + 0.3 * np.sin(3 * p[..., 0]) * np.cos(2 * p[..., 2]),
                                0.05, 1.0), path)
        paths.append(str(path))
    config = TerrainConfig(
        lod_count=LODS, model=TerrainModel.sphere(np.zeros(3), RADIUS, 0.0, MAX_HEIGHT),
        atlas_size=512, path="earth", assets_root=str(tmp / "assets"),
        attachments=(height_attachment(texture_size=512, mips=4),))
    Preprocessor(TileAtlas(config)).clear_attachment(0).preprocess_spherical(
        SphericalDataset(attachment_index=0, paths=paths, lod_range=range(0, DATA_LODS))
    ).run(verbose=False)
    terrain = Terrain(config)
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=capacity), queue_capacity=queue,
                     culling=True)
    view = np.array([0.0, 0.0, RADIUS + 60e3])
    vp = view_projection(view, view * 0.5, np.pi / 3, 16 / 9)
    for i in range(200):
        terrain.update({"cam": view}, {"cam": vp})
        if i > 3 and not terrain.atlas.state.to_load and not any(
                a.loading for a in terrain.atlas.attachments):
            break
        time.sleep(0.01)
    out = terrain.update({"cam": view}, {"cam": vp})["cam"]
    t = out.tiles
    return (np.asarray(t.tile_side)[:capacity], np.asarray(t.tile_lod)[:capacity],
            np.asarray(t.tile_xy)[:capacity], int(out.tile_count), view)


def test_morph_gating_counts_equal_the_jax_terrains(capsys):
    from bevy_terrain_tpu_torch.config import TerrainViewConfig
    from bevy_terrain_tpu_torch.math import TerrainModel
    from tools_torch.earth_frame_bench import MAX_HEIGHT, RADIUS

    got = morph_gating_analysis.main(EARTH)
    out = capsys.readouterr().out
    print(out)
    assert set(got) == {"tiles", "morphing_tiles", "live_steps", "steps", "morph_free_steps",
                        "morphing_per_step_quartiles"}
    assert got["tiles"] == 256 and got["steps"] == 4 and 0 < got["morphing_tiles"] <= 256
    assert "fully-morph-free live steps:" in out
    side, lod, xy, count, view = _jax_earth_tiles(256, 512)
    vc = TerrainViewConfig(tile_capacity=256)
    model = TerrainModel.sphere(np.zeros(3), RADIUS, 0.0, MAX_HEIGHT)
    want = morph_gating_analysis.analyse(side, lod, xy, count, model, view,
                                         vc.morph_distance * model.scale, vc.morph_range,
                                         0.5 * MAX_HEIGHT)
    assert got == want


@pytest.mark.parametrize("native_scan", [True, False], ids=["native", "numpy"])
def test_rust_interchange_check_reproduces_every_hash(monkeypatch, capsys, native_scan):
    if not native_scan:
        monkeypatch.setenv("BT_DISABLE_NATIVE", "1")
    before = native.counts().get("scan_requests", 0)
    got = rust_interchange.main(["--cpu", "--check"])
    scans = native.counts().get("scan_requests", 0) - before
    assert (scans > 0) == native_scan  # the scan ran natively, or in numpy
    expected = json.loads((ROOT / "tools" / "interchange_expected.json").read_text())
    assert got["expected"] == len(expected) == 29
    assert got["reproduced"] == 29 and not got["not_made"] and not got["differ"]
    assert sum(k.endswith(".csv") for k in expected) == 5
    assert "check OK: 29 of 29 committed hashes reproduced" in capsys.readouterr().out


def test_rust_interchange_names_what_it_cannot_make(monkeypatch, tmp_path, capsys):
    """Without PIL the source PNG is named, not hashed; --freeze writes the
    path it is given and the committed file stays as it is."""
    monkeypatch.setattr(rust_interchange, "write_png", lambda source, path: False)
    got = rust_interchange.check("cpu")
    assert got["not_made"] == ["source/height.png"] and got["reproduced"] == 28
    assert "not made here: ['source/height.png']" in capsys.readouterr().out
    committed = rust_interchange.EXPECTED.read_bytes()
    frozen = tmp_path / "frozen.json"
    manifest = rust_interchange.main(["--cpu", "--freeze", str(frozen)])
    assert json.loads(frozen.read_text()) == manifest and len(manifest) == 28
    assert rust_interchange.EXPECTED.read_bytes() == committed


def test_rust_interchange_comparators_pass_on_self(tmp_path):
    rust_interchange.main(["--cpu", "--emit", str(tmp_path / "kit")])
    root = tmp_path / "kit" / "assets" / "terrains" / "interchange"
    tc, tiles = str(root / "config.tc"), str(root / "data" / "height")
    assert rust_interchange.main(["--compare-tc", tc, tc]) == 0
    assert rust_interchange.main(["--compare-tiles", tiles, tiles]) == 0


def test_make_goldens_reproduces_the_committed_goldens(tmp_path, capsys):
    stamps = {p.name: p.stat().st_mtime_ns for p in make_goldens.GOLDEN_DIR.iterdir()}
    got = make_goldens.main(["--cpu", "--check", "--out", str(tmp_path)])
    print(capsys.readouterr().out)
    assert set(got) == set(make_goldens.NODE_CASES) | set(make_goldens.MESH_TOL)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{name}.npz" for name in got)
    assert got["mesh_planar_streamed"]["heights"] <= 1e-3
    assert {p.name: p.stat().st_mtime_ns for p in make_goldens.GOLDEN_DIR.iterdir()} == stamps
    with pytest.raises(SystemExit):
        make_goldens.main(["--cpu", "--out", str(make_goldens.GOLDEN_DIR)])
    assert os.listdir(make_goldens.GOLDEN_DIR) == list(stamps)
