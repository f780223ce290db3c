"""The metrics' arithmetic: percentiles, rates, device-busy unions,
idle gaps and the roofline shares read from traced frames."""

import pytest

from harness import layers, roofline, stats


def test_p90_is_linear_between_ranks():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_rate_is_over_the_whole_window():
    assert stats.rate(150, 30.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_union_busy_merges_overlaps_and_clips():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 50)]
    assert stats.union_busy(iv, 0, 100) == 15 + 11 + 10
    assert stats.union_busy(iv, 8, 45) == 7 + 11 + 5
    assert stats.union_busy([], 0, 10) == 0


def test_gaps_are_the_complement():
    iv = [(2, 4), (3, 6), (8, 9)]
    assert stats.gaps(iv, 0, 10) == [(0, 2), (6, 8), (9, 10)]
    lo, hi = 0, 10
    assert sum(e - s for s, e in stats.gaps(iv, lo, hi)) + stats.union_busy(iv, lo, hi) == hi - lo


def test_roofline_share_from_live_tiles():
    frames = [{"live": 1000, "update": [(0.0, 100.0, "void mesh_fused_kernel<true, false, 0>(x)"),
                                        (100.0, 900.0, "elementwise")]}]
    share = layers.roofline_pct({"frames": frames}, r"mesh_fused_kernel<true, false, 0>",
                                lambda live: roofline.mesh_s(live, "sphere"))
    want = 100.0 * roofline.mesh_s(1000, "sphere") / 100e-6
    assert share == pytest.approx(want)
    assert layers.roofline_pct({"frames": frames}, r"absent", lambda n: 1.0) is None


def test_bounds_grow_with_the_work():
    assert roofline.shaded_mesh_s(2000, 1) > roofline.mesh_s(2000, "planar")
    assert roofline.shaded_mesh_s(2000, 2) > roofline.shaded_mesh_s(2000, 1)
    assert roofline.sampler_s(2000) == pytest.approx(2 * roofline.sampler_s(1000))


def test_update_readers_count_kernels_and_render_span():
    from harness import manifest

    upd = [(0.0, 2.0, "void k1(x)"), (3.0, 4.0, "Memcpy HtoD (Pageable -> Device)"),
           (5.0, 9.0, "void k2(x)"), (9.0, 10.0, "Memset (Device)")]
    ren = [(20.0, 30.0, "void scan(x)"), (40.0, 1020.0, "void resolve(x)")]
    t = {"frames": [{"update": upd, "render": ren}] * 3}
    assert manifest.module("metrics", "update_kernels").read(t) == 2
    assert manifest.module("metrics", "update_device_ms").read(t) == pytest.approx(6e-3)
    assert manifest.module("metrics", "render_ms").read(t) == pytest.approx(1.0)
