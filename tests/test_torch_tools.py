"""The frame bench tool twins (tools_torch/) with ``--cpu``.

Each runs on the port at a shrunk size (the bench scene's atlas cut to 8
slots and, where the scene's tiles are sampled, its capacity to 512; the
flythrough's frames to 6 and its data lods to 2; the fetch sweep's quads to
512; the frame census's capacity to 512; the preprocess compute bench's
tiles to 64^2 from a 256^2 source; one timed call a row) and prints its
keys: the JAX tool's JSON keys, or its rows. On the CPU a row is host wall
or host self time, named so, never a device time.

``refine_bench``'s ``refine_tiles`` tile count on the bench scene equals
the JAX ``refine_tiles`` count on tools/multi_view_bench.py's
``build_scene``, exactly (both with one block per atlas slot: refinement
reads the uniforms only, so the random blocks are cut to that).
"""

import functools
import json

import pytest

import tools_torch.scenes as scenes
from bevy_terrain_tpu_torch.utils import timing
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)
from tools_torch import (
    census_frame, earth_census, earth_frame_bench, fetch_kernel_sweep, flythrough_bench,
    material_frame_bench, multi_view_bench, preprocess_compute_bench, raster_bench,
    refine_bench,
)


def _one_call(fn, *args, label="bench", on_card=True):
    assert not on_card  # --cpu: the tools never ask the CPU for a device time
    return timing.benchmark(fn, *args, n=1, warmup=0)["min_ms"], "CPU wall"


@pytest.fixture
def one_timed_call(monkeypatch):
    monkeypatch.setattr(scenes, "time_ms", _one_call)


@pytest.fixture
def small_scene(monkeypatch, one_timed_call):
    monkeypatch.setattr(scenes, "ATLAS_SLOTS", 8)
    monkeypatch.setattr(scenes, "build_scene", functools.partial(scenes.build_scene,
                                                                 capacity=512))


def _one_block_per_slot(monkeypatch, patch_sampling):
    make = patch_sampling.make_patch_plan
    monkeypatch.setattr(patch_sampling, "make_patch_plan",
                        lambda *a: make(*a)._replace(total_blocks_per_slot=1))


def test_refine_bench_tile_count_equals_jax(monkeypatch, capsys, one_timed_call):
    import bevy_terrain_tpu.ops.patch_sampling as jpatch_sampling
    import tools.multi_view_bench as jscene
    from bevy_terrain_tpu.ops import refinement as jrefinement

    _one_block_per_slot(monkeypatch, jpatch_sampling)
    jcfg, _, jblocks, ju1, _ = jscene.build_scene()
    assert jblocks.shape[0] == 1024
    want = int(jrefinement.refine_tiles(ju1, jcfg).tile_count)

    _one_block_per_slot(monkeypatch, scenes.patch_sampling)
    got = refine_bench.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    assert got["tiles"] == want == 2582
    assert "planar refine_tiles" in out and f"(tiles {want})" in out
    for row in ("planar pred batch", "planar dense sort x5", "planar dense sort x1"):
        assert row in out
    assert got["timing"] == "CPU wall" and all(v > 0 for v in got["ms"].values())


def _json_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_earth_frame_bench_prints_its_keys(capsys):
    got = earth_frame_bench.main(["--cpu"])
    printed = _json_line(capsys.readouterr().out)
    assert printed == got
    assert set(printed) == {"benchmark", "backend", "altitude_km", "lod_count", "tiles",
                            "capacity", "overflow", "device_ms", "update_wall_ms"}
    assert printed["backend"] == "cpu" and printed["device_ms"] is None
    # the 60 km Earth frame of the JAX tool (PERF.md section 4)
    assert printed["tiles"] == 1512 and printed["overflow"] == 0


def _two_data_lods(monkeypatch):
    from bevy_terrain_tpu_torch.utils import synthetic

    generate = synthetic.generate_planar_dataset
    monkeypatch.setattr(synthetic, "generate_planar_dataset",
                        lambda path, lods, *a, **k: generate(path, min(lods, 2), *a, **k))


def test_flythrough_bench_prints_its_keys(monkeypatch, capsys):
    _two_data_lods(monkeypatch)
    got = flythrough_bench.main(["--cpu", "--frames", "6"])
    printed = _json_line(capsys.readouterr().out)
    assert printed == got
    assert set(printed) == {
        "benchmark", "backend", "frames", "lod_count", "data_lods", "terrain_km",
        "dataset_gen_s", "flythrough_wall_s", "host_scan_ms_p50", "host_scan_ms_p95",
        "frame_wall_ms_p50", "frame_wall_ms_p95", "tiles_p50", "tiles_max",
        "final_tile_count", "tiles_loaded", "loads_per_s", "overflow_frames",
        "resident_tiles"}
    assert printed["backend"] == "cpu" and printed["frames"] == 6
    assert printed["overflow_frames"] == 0 and printed["tiles_loaded"] > 0


def test_material_frame_bench_prints_its_rows(capsys, small_scene):
    got = material_frame_bench.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    for row in ("mesh-only frame:", "+ fused_to_grid:", "[RGBA x4 planar:",
                "+ RGBA packed fetch:", "[RGBA x4 grad-4-tap:", "+ PBR shade = full:",
                "MERGED mesh+RGBA:", "MERGED + PBR = full:", "ONE-KERNEL material:",
                "ONE-KERNEL + 1-DMA:", "ONE-KERNEL opaque:"):
        assert row in out, row
    assert got["timing"] == "CPU wall" and len(got["ms"]) == 11
    par = got["parity"]
    # the packed and 4-array samplers, the combined blocks and the opaque RGB
    # are bit-equal; the merged kernel's fast albedo within 2/255 of the
    # sampler; the in-kernel shade within 1e-4 of the staged one
    assert par["packed"] == par["combined"] == par["opaque"] == 0.0
    assert par["merged"] <= 2.0 / 255.0 and par["shade"] <= 1e-4


def test_raster_bench_prints_its_rows(capsys, small_scene):
    got = raster_bench.main(["--cpu", "--size", "64"])
    out = capsys.readouterr().out
    print(out)
    assert "scene: 512 tiles, image 64x64" in out
    for row in ("raster_only", "render_pixel", "render_debug"):
        assert f"{row} " in out and got["ms"][row] > 0
    assert 0.0 < got["coverage"] <= 1.0 and got["timing"] == "CPU wall"


def test_multi_view_bench_prints_its_rows(capsys, small_scene, monkeypatch):
    # the structure check's ranks and report run in tests/test_torch_multi_card.py's
    # spawn (test_multi_view_bench_structure_check_on_the_group); here, its wiring
    found = {"replicated-atlas": {}}
    monkeypatch.setattr(multi_view_bench, "structure_check", lambda: found)
    got = multi_view_bench.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    for row in ("single view:", "two views, one card, shared atlas:", "per-view ratio",
                "MultiViewTerrain (staged grid path): ok"):
        assert row in out, row
    assert got["structure"] is found
    assert got["timing"] == "CPU wall" and got["single_us"] > 0 and got["double_us"] > 0
    # capacity 512: the bench camera and the second one both fill it
    assert got["single_tiles"] == 512 and got["double_tiles"] == [512, 512]
    assert got["multi_view_tiles"] > 0 and not got["multi_view_fused"]


def test_fetch_kernel_sweep_holds_k7_to_the_staged_functions(capsys, one_timed_call):
    from bevy_terrain_tpu_torch.ops import kernels

    waves = kernels.HALFGRID_WAVES
    got = fetch_kernel_sweep.main(["--cpu", "3", "512"])
    out = capsys.readouterr().out
    print(out)
    assert "waves=3 max |kernel - staged|" in out and "waves=3 CPU wall:" in out
    assert got["waves"] == 3 and got["tiles"] == 8192 and got["n_blocks"] == 512
    assert got["max_abs_err"] < 1e-2 and got["timing"] == "CPU wall"
    assert kernels.HALFGRID_WAVES == waves  # the sweep's setting is undone


def test_census_frame_prints_its_top_ops(monkeypatch, capsys):
    monkeypatch.setattr(scenes, "ATLAS_SLOTS", 8)
    monkeypatch.setattr(census_frame, "CAPACITY", 512)
    got = census_frame.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    assert "census_frame: CPU self time total" in out
    assert got["timing"] == "CPU self time" and got["total_ms"] > 0
    assert got["tiles"] == 512 and len(got["top"]) == 30
    assert all(ms > 0 for _, _, ms in got["top"])


def test_earth_census_prints_its_top_ops(capsys):
    got = earth_census.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    assert "earth_census: CPU self time total" in out and len(got["top"]) == 30
    # the 60 km Earth frame of tools/earth_frame_bench.py (PERF.md section 4)
    assert got["tiles"] == 1512 and got["overflow"] == 0


def test_preprocess_compute_bench_prints_its_rows(monkeypatch, capsys):
    monkeypatch.setattr(preprocess_compute_bench, "TS", 64)
    monkeypatch.setattr(preprocess_compute_bench, "SOURCE", 256)
    got = preprocess_compute_bench.main(["--cpu"])
    out = capsys.readouterr().out
    print(out)
    for row in ("CPU torch ops compute:", "host compute:", "ratio:"):
        assert row in out, row
    # 4 lods of 8^2 + 4^2 + 2^2 + 1 tiles stitched, plus the 64 split: the
    # JAX tool's counts
    assert got["device_tiles"] == 85 + 64 and got["host_tiles"] == 85
    assert got["timing"] == "CPU torch ops" and got["ratio"] > 0


@pytest.mark.parametrize("tool", [refine_bench, material_frame_bench, raster_bench,
                                  earth_frame_bench, flythrough_bench, multi_view_bench,
                                  fetch_kernel_sweep, census_frame, earth_census,
                                  preprocess_compute_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_run_on_the_card_by_default(tool, monkeypatch):
    """No fallback: without ``--cpu`` a tool asks for the card, and raises
    without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    monkeypatch.setattr(scenes, "ATLAS_SLOTS", 8)
    _two_data_lods(monkeypatch)
    with pytest.raises((RuntimeError, AssertionError)):
        tool.main([])
