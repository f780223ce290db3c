"""The port's native runtime (bevy_terrain_tpu_torch/native) on the CPU.

1. Its entry points against the port's own Python oracles, the cases of
   tests/test_native.py: the residency machine (fuzzed operation
   sequences, exhaustion, double release, the over-release guard, LRU
   revival), the IO pool, the request scan over camera walks on the three
   model kinds, the Taylor chain, the bilinear tap, the full Taylor path
   from a world position, the view anchors, quantize and downsample. Every
   comparison is exact: the port's numpy oracles are written in the native
   op order, bit for bit.
2. Each entry point against the JAX package's native runtime
   (bevy_terrain_tpu.native) on the same seeded inputs, byte for byte.
3. The build: a failed compile raises with the compiler's message, and
   concurrent first builds share one library.
4. The slice: the port's ``Terrain`` and the JAX ``Terrain``, both on their
   native runtimes, over a short streamed planar flythrough and a planet
   descent: per frame the requested and released keys, the entries and the
   packed uniforms (Taylor coefficients included) are equal, and the
   meshes agree within test_torch_staged_pipeline.py's yardsticks.
"""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from bevy_terrain_tpu import native as jnative
from bevy_terrain_tpu_torch import native
from bevy_terrain_tpu_torch.math.coordinate import TileCoordinate
from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlasState, pack_keys
from tests.test_torch_examples import jax_and_port_loads_in_step  # noqa: F401 (fixture)
from tests.test_torch_patch_sampling import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def key_of(c: TileCoordinate) -> int:
    return int(pack_keys(c.side, c.lod, c.x, c.y))


def quad_tiles(lods=4):
    return [TileCoordinate(0, lod, x, y)
            for lod in range(lods) for x in range(1 << lod) for y in range(1 << lod)]


def make_pair(atlas_size=16, attachments=2, lods=4):
    """(the Python machine, the native machine, the tiles), both over a
    quadtree of ``lods`` lods on side 0."""
    tiles = quad_tiles(lods)
    py = TileAtlasState(atlas_size, attachments, tiles, use_native=False)
    nat = native.NativeResidency(atlas_size, attachments)
    nat.add_existing(np.array([key_of(t) for t in tiles], np.int64))
    return py, nat, tiles


def numpy_path(monkeypatch):
    """Make every optional native branch take its Python path."""
    monkeypatch.setattr(native, "available", lambda: False)


def sphere_case(rng):
    """(model, world view position, origin lod) of a random sphere view."""
    from bevy_terrain_tpu_torch.math import TerrainModel

    R = 6_371_000.0 * rng.uniform(0.4, 2.0)
    center = rng.normal(0, 1e5, 3)
    model = TerrainModel.sphere(center, R, 0.0, 9000.0)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    return model, center + d * R * rng.uniform(1.0001, 1.5), int(rng.integers(2, 14))


# -- 1. the entry points against the port's Python oracles ---------------------------


class TestEquivalence:
    def test_fuzz_sequences(self):
        rng = np.random.default_rng(42)
        py, nat, tiles = make_pair()
        held = []
        loading = {}  # coord -> remaining attachments

        for step in range(3000):
            op = rng.integers(0, 4)
            if op == 0 and len(held) < 14:  # request
                t = tiles[rng.integers(0, len(tiles))]
                before = t in py.tile_states
                py.request_tile(t)
                n_idx = nat.request(key_of(t))
                assert py.tile_states[t].atlas_index == n_idx, step
                if not before:
                    loading[t] = py.attachment_count
                held.append(t)
            elif op == 1 and held:  # release
                t = held.pop(rng.integers(0, len(held)))
                py.release_tile(t)
                nat.release(key_of(t))
            elif op == 2 and loading:  # one attachment load completes
                t = list(loading)[rng.integers(0, len(loading))]
                if t in py.tile_states:

                    class _T:
                        coordinate = t
                        atlas_index = py.tile_states[t].atlas_index
                        attachment_index = 0

                    py.load_slots -= 1  # loaded_tile_attachment refunds one
                    py.loaded_tile_attachment(_T())
                    nat.loaded(key_of(t))
                loading[t] -= 1
                if loading[t] == 0:
                    del loading[t]
            else:  # compare best tiles over a probe set
                side = np.zeros(64, np.int32)
                lod = rng.integers(0, 4, 64).astype(np.int32)
                x = rng.integers(0, 8, 64).astype(np.int32) % (1 << lod)
                y = rng.integers(0, 8, 64).astype(np.int32) % (1 << lod)
                pi, pl = py.get_best_tiles(side, lod, x, y)
                ni, nl = nat.best_tiles(side, lod, x, y)
                np.testing.assert_array_equal(pi, ni, err_msg=f"step {step}")
                np.testing.assert_array_equal(pl, nl, err_msg=f"step {step}")

        # drained load queues match in order
        pk = [(key_of(e.coordinate), e.atlas_index, e.attachment_index) for e in py.to_load]
        nk, ni, na = nat.drain_loads(8192)
        assert pk == list(zip(nk.tolist(), ni.tolist(), na.tolist()))

    def test_exhaustion_raises(self):
        py, nat, tiles = make_pair(atlas_size=2)
        lod1 = [t for t in tiles if t.lod == 1]
        nat.request(key_of(lod1[0]))
        nat.request(key_of(lod1[1]))
        with pytest.raises(RuntimeError, match="out of indices"):
            nat.request(key_of(lod1[2]))

    def test_double_release_raises(self):
        py, nat, tiles = make_pair()
        with pytest.raises(RuntimeError, match="not present"):
            nat.release(key_of(tiles[0]))

    def test_over_release_cached_parity(self):
        """Both backends guard (not underflow) an over-release of a
        cached tile and count it identically."""
        py, nat, tiles = make_pair()
        t = tiles[0]
        py.request_tile(t)
        nat.request(key_of(t))
        py.release_tile(t)
        nat.release(key_of(t))
        py.release_tile(t)  # over-release
        nat.release(key_of(t))
        assert py.release_underflows == 1
        assert nat.release_underflows == 1
        assert py.tile_states[t].requests == 0
        assert nat.requests_of(key_of(t)) == 0
        py.request_tile(t)
        idx = nat.request(key_of(t))
        assert py.tile_states[t].atlas_index == idx
        assert py.tile_states[t].requests == 1
        assert nat.requests_of(key_of(t)) == 1

    def test_lru_eviction_and_revival(self):
        py, nat, tiles = make_pair(atlas_size=3, attachments=1)
        lod1 = [t for t in tiles if t.lod == 1]
        a = nat.request(key_of(lod1[0]))
        nat.request(key_of(lod1[1]))
        nat.release(key_of(lod1[0]))
        # revival: re-request before eviction keeps the same slot
        assert nat.request(key_of(lod1[0])) == a
        nat.release(key_of(lod1[0]))
        nat.release(key_of(lod1[1]))
        # the FIFO holds [2, a, b]: the fresh slot first, then lod1[0]'s
        assert nat.request(key_of(lod1[2])) == 2
        assert nat.request(key_of(lod1[3])) == a  # evicted lod1[0]
        assert nat.index_of(key_of(lod1[0])) == -1


def test_mirrored_state_matches_the_python_state():
    """``TileAtlasState`` with its native mirror against the one without,
    through the public transitions on a small atlas: requests past
    exhaustion (denied, then retried), releases (of denied requests too),
    over-releases, loads, preprocessing allocations and the best-tiles walk
    all decide the same."""
    rng = np.random.default_rng(5)
    tiles = quad_tiles(4)
    mirrored = TileAtlasState(6, 1, tiles, use_native=True)
    python = TileAtlasState(6, 1, tiles, use_native=False)
    assert mirrored._native is not None and python._native is None
    held = []
    native.reset_counts()
    for step in range(2000):
        op = rng.integers(0, 7)
        if op == 0 and len(held) < 10:
            t = tiles[rng.integers(0, len(tiles))]
            for s in (mirrored, python):
                s.request_tile(t)
            held.append(t)
        elif op == 1 and held:
            t = held.pop(rng.integers(0, len(held)))
            for s in (mirrored, python):
                s.release_tile(t)
        elif op == 2 and python.to_load:
            entry = python.to_load[0]
            state = python.tile_states.get(entry.coordinate)
            live = state is not None and state.atlas_index == entry.atlas_index \
                and state.loading_remaining > 0  # else its tile was evicted
            for s in (mirrored, python):
                s.to_load.popleft()
                if live:
                    s.load_slots -= 1  # loaded_tile_attachment refunds one
                    s.loaded_tile_attachment(entry)
        elif op == 3:
            for s in (mirrored, python):
                s.retry_denied()
        elif op == 5:  # over-release a cached tile
            cached = [c for c, st in python.tile_states.items()
                      if st.requests == 0 and c not in python._denied]
            if cached:
                t = cached[rng.integers(0, len(cached))]
                for s in (mirrored, python):
                    s.release_tile(t)
        elif op == 4 and rng.random() < 0.05 and python.unused_tiles:
            t = tiles[rng.integers(0, len(tiles))]
            assert mirrored.get_or_allocate_tile(t) == python.get_or_allocate_tile(t), step
        else:
            side = np.zeros((4, 8), np.int32)
            lod = rng.integers(0, 4, (4, 8)).astype(np.int32)
            x = rng.integers(0, 8, (4, 8)).astype(np.int32) % (1 << lod)
            y = rng.integers(0, 8, (4, 8)).astype(np.int32) % (1 << lod)
            got, want = mirrored.get_best_tiles(side, lod, x, y), python.get_best_tiles(
                side, lod, x, y)
            for g, w in zip(got, want):
                assert g.shape == w.shape == (4, 8)
                np.testing.assert_array_equal(g, w, err_msg=f"step {step}")
        assert {c: (s.atlas_index, s.requests, s.loading_remaining)
                for c, s in mirrored.tile_states.items()} == {
            c: (s.atlas_index, s.requests, s.loading_remaining)
            for c, s in python.tile_states.items()}, step
        assert [key_of(e.coordinate) for e in mirrored.to_load] == [
            key_of(e.coordinate) for e in python.to_load], step
    for attr in ("exhausted_requests", "release_underflows"):
        assert getattr(mirrored, attr) == getattr(python, attr), attr
    assert python.exhausted_requests > 0 and python.release_underflows > 0
    for c, s in python.tile_states.items():
        assert mirrored._native.index_of(key_of(c)) == s.atlas_index
        assert mirrored._native.requests_of(key_of(c)) == s.requests
    calls = native.counts()
    for name in ("request", "release", "loaded", "get_or_allocate", "drain_loads",
                 "best_tiles"):
        assert calls[f"NativeResidency.{name}"] > 0, name


class TestNativeIo:
    def test_reads_files(self, tmp_path):
        pool = native.NativeIoPool(threads=2)
        payloads = {}
        for i in range(8):
            p = tmp_path / f"tile{i}.bin"
            data = np.random.default_rng(i).integers(0, 255, 1000, np.uint8)
            p.write_bytes(data.tobytes())
            payloads[pool.submit(str(p), 1000)] = data
        got = []
        for _ in range(200):
            got += pool.poll()
            if len(got) == 8:
                break
            time.sleep(0.005)
        assert len(got) == 8
        for job_id, size, buf in got:
            assert size == 1000
            np.testing.assert_array_equal(buf, payloads[job_id])

    def test_missing_file_reports_error(self, tmp_path):
        pool = native.NativeIoPool(threads=1)
        job = pool.submit(str(tmp_path / "nope.bin"), 100)
        for _ in range(200):
            done = pool.poll()
            if done:
                break
            time.sleep(0.005)
        assert done[0][0] == job and done[0][1] is None


def _walk_model(kind):
    from bevy_terrain_tpu_torch.math import TerrainModel

    if kind == "sphere":
        return TerrainModel.sphere(np.array([10.0, -5.0, 2.0]), 1000.0, 0.0, 50.0)
    if kind == "ellipsoid":
        # distinct axes exercise the anisotropic world transform in the C++
        # slot_world (the normal path uses the inverse-transpose)
        return TerrainModel.ellipsoid(np.array([10.0, -5.0, 2.0]), 1000.0, 940.0, 0.0, 50.0)
    return TerrainModel.planar(np.array([3.0, -100.0, 7.0]), 1000.0, 0.0, 250.0)


class TestNativeRequestScan:
    """tr_scan_requests against the vectorized numpy oracle: identical slot
    state and identical release/request SETS over random camera walks (the
    interleaving of old/new releases within a frame may differ; a release
    list is consumed refcount-wise, so order is immaterial)."""

    @pytest.mark.parametrize("kind", ["planar", "sphere", "ellipsoid"])
    def test_fuzz_camera_walk(self, kind):
        from bevy_terrain_tpu_torch.config import TerrainConfig, TerrainViewConfig
        from bevy_terrain_tpu_torch.terrain_data.tile_atlas import TileAtlas
        from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree

        rng = np.random.default_rng(17)
        model = _walk_model(kind)
        config = TerrainConfig(lod_count=5, model=model, atlas_size=64, path="x")
        atlas = TileAtlas(config, "cpu")
        vc = TerrainViewConfig()
        t_native = TileTree(atlas, vc)
        t_numpy = TileTree(atlas, vc)
        t_native._native_scan = True
        t_numpy._native_scan = False

        def key_set(tiles):
            return sorted((c.side, c.lod, c.x, c.y) for c in tiles)

        pos = np.array([0.0, 0.0, 1400.0]) if model.is_spherical else np.array(
            [120.0, 80.0, -60.0])
        native.reset_counts()
        for step in range(40):
            pos = pos + rng.normal(scale=60.0, size=3)
            if model.is_spherical:
                # keep the camera outside the planet
                r = np.linalg.norm(pos - model.translation)
                if r < 1050.0:
                    pos = model.translation + (pos - model.translation) * (1100.0 / r)
            t_native.compute_requests(pos)
            t_numpy.compute_requests(pos)
            np.testing.assert_array_equal(t_native.tile_xy, t_numpy.tile_xy, err_msg=str(step))
            np.testing.assert_array_equal(t_native.tile_requested, t_numpy.tile_requested,
                                          err_msg=str(step))
            for a, b in (("origins", "origins"), ("view_tile_int", "view_tile_int"),
                         ("view_tile_frac", "view_tile_frac")):
                assert getattr(t_native, a).tobytes() == getattr(t_numpy, b).tobytes(), a
            assert key_set(t_native.released_tiles) == key_set(t_numpy.released_tiles), step
            assert key_set(t_native.requested_tiles) == key_set(t_numpy.requested_tiles), step
        assert t_native.tile_xy.dtype == np.int64 and t_native.tile_xy.flags.c_contiguous
        assert t_native.tile_requested.dtype == bool
        calls = native.counts()
        assert calls["scan_requests"] == calls["view_anchors"] == 40
        assert calls["project_view_uv"] == (40 if kind == "sphere" else 0)


def _numpy_approx(monkeypatch, model, view, lod):
    from bevy_terrain_tpu_torch.math.approximation import TerrainModelApproximation

    with monkeypatch.context() as m:
        numpy_path(m)
        return TerrainModelApproximation.compute(model, view, lod, 1000.0)


def _assert_same_approx(got, want):
    for name in ("origin_xy", "origin_uv", "c", "c_s", "c_t", "c_ss", "c_st", "c_tt"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


class TestNativeTaylor:
    def test_matches_numpy_chain(self, monkeypatch):
        """tr_taylor_spherical against the numpy derivative chain, random
        views, bit for bit."""
        from bevy_terrain_tpu_torch.math.coordinate import Coordinate, project_uv_to_side

        rng = np.random.default_rng(11)
        for _ in range(20):
            model, view, lod = sphere_case(rng)
            vc = Coordinate.from_world_position(np.asarray(view, np.float64), model)
            uv = project_uv_to_side(
                np.full(6, vc.side, np.int32), np.arange(6, dtype=np.int32),
                np.broadcast_to(np.asarray(vc.uv, np.float64), (6, 2)),
            )
            m = np.asarray(model.world_from_local, np.float64)[:3, :4]
            oxy, ouv, co = native.taylor_spherical(uv, np.asarray(view, np.float64), m,
                                                   float(1 << lod))
            want = _numpy_approx(monkeypatch, model, view, lod)
            assert oxy.tobytes() == want.origin_xy.tobytes()
            assert ouv.tobytes() == want.origin_uv.tobytes()
            for i, name in enumerate(["c", "c_s", "c_t", "c_ss", "c_st", "c_tt"]):
                assert co[i].tobytes() == getattr(want, name).tobytes(), name


class TestNativeBilinear:
    def test_matches_numpy_tap(self):
        """tr_sample_bilinear against attachment.sample_bilinear_host, all
        dtypes, bit for bit."""
        from bevy_terrain_tpu_torch.terrain_data.attachment import sample_bilinear_host

        rng = np.random.default_rng(7)
        cases = [
            (rng.integers(0, 65535, (64, 64, 1)).astype(np.uint16), 65535.0),
            (rng.integers(0, 255, (32, 32, 4)).astype(np.uint8), 255.0),
            (rng.integers(0, 65535, (16, 16, 2)).astype(np.uint16), 65535.0),
            (rng.random((48, 48, 1)).astype(np.float32), 1.0),
        ]
        for data, max_value in cases:
            for _ in range(40):
                uv = rng.uniform(-0.2, 1.2, 2)
                got = native.sample_bilinear(data, uv, max_value)
                want = sample_bilinear_host(data, uv, max_value)
                assert got.tobytes() == np.asarray(want, np.float64).tobytes()

    def test_full_path_from_world(self, monkeypatch):
        """tr_taylor_from_world (face pick + warp + projection + chain)
        against the numpy oracle through TerrainModelApproximation.compute."""
        from bevy_terrain_tpu_torch.math.approximation import TerrainModelApproximation

        rng = np.random.default_rng(13)
        native.reset_counts()
        for _ in range(20):
            model, view, lod = sphere_case(rng)
            got = TerrainModelApproximation.compute(model, view, lod, 1000.0)
            _assert_same_approx(got, _numpy_approx(monkeypatch, model, view, lod))
        assert native.taylor_from_world.calls == 20


class TestNativeViewAnchors:
    def test_matches_numpy_anchors(self):
        """tr_project_view_uv + tr_view_anchors against compute_view_anchors
        across all three model kinds and random views, bit for bit."""
        from bevy_terrain_tpu_torch.config import TerrainViewConfig
        from bevy_terrain_tpu_torch.math import TerrainModel
        from bevy_terrain_tpu_torch.ops.tile_tree import compute_view_anchors
        from bevy_terrain_tpu_torch.terrain_data.tile_tree import TileTree

        class _FakeAtlas:
            def __init__(self, model, lod_count):
                self.model = model
                self.lod_count = lod_count

        rng = np.random.default_rng(17)
        for trial in range(60):
            kind = trial % 3
            if kind == 0:
                model = TerrainModel.planar(
                    rng.normal(0, 100, 3), rng.uniform(100, 5000), 0.0, 100.0)
                view = np.asarray(rng.normal(0, 2000, 3))
            elif kind == 1:
                R = rng.uniform(1e3, 1e7)
                c = rng.normal(0, 1e3, 3)
                model = TerrainModel.sphere(c, R, 0.0, R * 0.01)
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
                view = c + d * R * rng.uniform(1.0001, 2.0)
            else:
                A = rng.uniform(1e6, 1e7)
                c = rng.normal(0, 1e3, 3)
                model = TerrainModel.ellipsoid(c, A, A * 0.97, 0.0, 9000.0)
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
                view = c + d * A * rng.uniform(1.001, 1.5)
            L = int(rng.integers(2, 12))
            T = int(rng.integers(2, 9))
            tree = TileTree(_FakeAtlas(model, L), TerrainViewConfig(tree_size=T))
            tree.view_world_position = np.asarray(view, np.float64)
            tree._compute_anchors_native()
            o, i, f = compute_view_anchors(model, view, L, T)
            np.testing.assert_array_equal(tree.origins, o)
            np.testing.assert_array_equal(tree.view_tile_int, i)
            assert tree.view_tile_frac.tobytes() == f.tobytes()


def _downsample_children(rng, ts, C, dtype):
    mv = 65535 if dtype == np.uint16 else 255
    children = []
    for _ in range(4):
        if rng.random() < 0.2:
            children.append(None)
            continue
        ch = rng.integers(0, mv + 1, (ts, ts, C)).astype(dtype)
        ch[rng.random((ts, ts)) < 0.3] = 0  # nodata texels
        children.append(ch)
    return children


class TestPreprocessHelpers:
    """C++ preprocess hot loops against their numpy oracles (bit-exact)."""

    def test_quantize_matches_numpy(self):
        rng = np.random.default_rng(11)
        for dtype, mv in ((np.uint16, 65535.0), (np.uint8, 255.0)):
            src = (rng.random((257, 93, 2), np.float32) * 1.2 - 0.05).astype(np.float32)
            ref = np.clip(np.rint(src * mv), 0, mv).astype(dtype)
            np.testing.assert_array_equal(ref, native.quantize(src, mv, dtype))

    def test_downsample_matches_numpy(self):
        from bevy_terrain_tpu_torch.ops.preprocess import downsample_tile_numpy

        rng = np.random.default_rng(12)
        for trial in range(20):
            ts = int(rng.choice([16, 40, 128]))
            C = int(rng.choice([1, 2, 4]))
            dtype = np.uint16 if trial % 2 == 0 else np.uint8
            children = _downsample_children(rng, ts, C, dtype)
            ref = downsample_tile_numpy(children, ts, 2)
            got = native.downsample(children, ts, 2, dtype, C)
            np.testing.assert_array_equal(np.asarray(ref, np.int64), np.asarray(got, np.int64))

    def test_split_matches_numpy(self, monkeypatch):
        """``split_mosaic``'s 2-tap branch through tr_split_bilinear against
        its numpy branch (bit-exact mosaic and validity)."""
        from bevy_terrain_tpu_torch.ops.preprocess import split_mosaic

        rng = np.random.default_rng(14)
        source = rng.random((301, 257, 2), np.float32)
        source[rng.random((301, 257)) < 0.02] = 0.0  # nodata
        native.reset_counts()
        got = split_mosaic(source, 3, 60, (0.1, 0.05), (0.93, 0.97))
        assert native.split_bilinear.calls > 0
        with monkeypatch.context() as m:
            numpy_path(m)
            want = split_mosaic(source, 3, 60, (0.1, 0.05), (0.93, 0.97))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# -- 2. each entry point against the JAX package's native runtime --------------------


def _same(*pairs):
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def _cross_scan(rng):
    from bevy_terrain_tpu_torch.ops.tile_tree import compute_view_anchors

    for kind, pos0 in (("planar", (120.0, 80.0, -60.0)), ("sphere", (0.0, 0.0, 1400.0)),
                       ("ellipsoid", (0.0, 900.0, 800.0))):
        model = _walk_model(kind)
        S, L, T = model.side_count, 5, 8
        m = np.ascontiguousarray(np.asarray(model.world_from_local, np.float64)[:3, :4])
        inv = np.ascontiguousarray(np.linalg.inv(m[:3, :3]))
        state = [(np.full((S, L, T, T, 2), -1, np.int64), np.zeros((S, L, T, T), bool))
                 for _ in range(2)]
        pos = np.asarray(pos0)
        for _ in range(10):
            pos = pos + rng.normal(scale=60.0, size=3)
            anchors = compute_view_anchors(model, pos, L, T)
            outs = [mod.scan_requests(int(model.is_spherical), m, inv, pos, 20.0, 3000.0,
                                      *anchors[:2], anchors[2].astype(np.float64), xy, req)
                    for mod, (xy, req) in zip((native, jnative), state)]
            _same(*zip(*outs), (state[0][0], state[1][0]), (state[0][1], state[1][1]))


def _cross_residency(rng):
    tiles = quad_tiles(4)
    keys = np.array([key_of(t) for t in tiles], np.int64)
    machines = [mod.NativeResidency(8, 2) for mod in (native, jnative)]
    for nat in machines:
        nat.add_existing(keys)
    held, loading = [], []
    for _ in range(1500):
        op = rng.integers(0, 5)
        if op == 0 and len(held) < 7:
            k = int(keys[rng.integers(0, len(keys))])
            assert len({nat.request(k) for nat in machines}) == 1
            held.append(k)
            loading += [k, k]
        elif op == 1 and held:
            k = held.pop(rng.integers(0, len(held)))
            for nat in machines:
                nat.release(k)
        elif op == 2 and loading:
            k = loading.pop(rng.integers(0, len(loading)))
            if machines[1].index_of(k) >= 0:
                codes = []
                for nat in machines:
                    try:
                        nat.loaded(k)
                        codes.append(0)
                    except RuntimeError:
                        codes.append(1)
                assert codes[0] == codes[1]
        elif op == 3:
            _same(*zip(*(nat.drain_loads(64) for nat in machines)))
        else:
            probe = [rng.integers(0, 4, 32).astype(np.int32)]
            probe += [rng.integers(0, 8, 32).astype(np.int32) % (1 << probe[0])
                      for _ in range(2)]
            _same(*zip(*(nat.best_tiles(np.zeros(32, np.int32), *probe)
                         for nat in machines)))
    k = int(pack_keys(1, 0, 0, 0))
    _same((machines[0].get_or_allocate(k), machines[1].get_or_allocate(k)))
    for attr in ("resident_count", "release_underflows", "existing_count"):
        assert getattr(machines[0], attr) == getattr(machines[1], attr), attr


def _cross_io_pool(rng, tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"t{i}.bin"
        p.write_bytes(rng.integers(0, 255, 777, np.uint8).tobytes())
        paths.append(p)
    paths.append(tmp_path / "missing.bin")
    results = []
    for mod in (native, jnative):
        pool = mod.NativeIoPool(threads=2)
        for p in paths:
            pool.submit(str(p), 1024)
        got = []
        for _ in range(400):
            got += pool.poll()
            if len(got) == len(paths):
                break
            time.sleep(0.005)
        results.append(sorted((j, size, bytes(buf[: size or 0])) for j, size, buf in got))
    assert len(results[0]) == len(paths) and results[0] == results[1]


def _cross_taylor(rng, name):
    from bevy_terrain_tpu_torch.math.coordinate import Coordinate, project_uv_to_side

    for _ in range(20):
        model, view, lod = sphere_case(rng)
        m = np.asarray(model.world_from_local, np.float64)[:3, :4]
        lm = np.asarray(model.local_from_world, np.float64)[:3, :4]
        if name == "taylor_spherical":
            vc = Coordinate.from_world_position(view, model)
            uv = project_uv_to_side(np.full(6, vc.side, np.int32), np.arange(6, dtype=np.int32),
                                    np.broadcast_to(np.asarray(vc.uv, np.float64), (6, 2)))
            args = (uv, view, m, float(1 << lod))
        elif name == "taylor_from_world":
            args = (view, m, lm, float(1 << lod))
        else:
            args = (view, lm)
        got, want = getattr(native, name)(*args), getattr(jnative, name)(*args)
        if isinstance(got, tuple):
            _same(*zip(got, want))
        else:
            _same((got, want))


def _cross_view_anchors(rng):
    for _ in range(30):
        S, L, T = int(rng.choice([1, 6])), int(rng.integers(2, 14)), int(rng.integers(2, 9))
        side_uv = rng.uniform(-0.1, 1.1, (S, 2))
        outs = [(np.zeros((S, L, 2), np.int32), np.zeros((S, L, 2), np.int32),
                 np.zeros((S, L, 2), np.float32)) for _ in range(2)]
        for mod, out in zip((native, jnative), outs):
            mod.view_anchors(side_uv, L, T, *out)
        _same(*zip(*outs))


def _cross_preprocess(rng, name):
    if name == "sample_bilinear":
        for data, mv in ((rng.integers(0, 65535, (64, 64, 1)).astype(np.uint16), 65535.0),
                         (rng.integers(0, 255, (32, 32, 4)).astype(np.uint8), 255.0),
                         (rng.random((48, 48, 2)).astype(np.float32), 1.0)):
            for _ in range(40):
                uv = rng.uniform(-0.2, 1.2, 2)
                _same((native.sample_bilinear(data, uv, mv), jnative.sample_bilinear(data, uv, mv)))
    elif name == "split_bilinear":
        source = rng.random((203, 157, 3), np.float32)
        px, py = rng.uniform(-3.0, 160.0, 211), rng.uniform(-3.0, 206.0, 67)
        _same((native.split_bilinear(source, px, py), jnative.split_bilinear(source, px, py)))
    elif name == "quantize":
        for dtype, mv in ((np.uint16, 65535.0), (np.uint8, 255.0)):
            src = (rng.random((131, 77, 2), np.float32) * 1.2 - 0.05).astype(np.float32)
            _same((native.quantize(src, mv, dtype), jnative.quantize(src, mv, dtype)))
    else:
        for trial in range(12):
            ts, C = int(rng.choice([16, 40, 128])), int(rng.choice([1, 2, 4]))
            dtype = np.uint16 if trial % 2 == 0 else np.uint8
            children = _downsample_children(rng, ts, C, dtype)
            _same((native.downsample(children, ts, 2, dtype, C),
                   jnative.downsample(children, ts, 2, dtype, C)))


ENTRY_POINTS = ["scan_requests", "residency", "io_pool", "taylor_spherical",
                "taylor_from_world", "project_view_uv", "view_anchors", "sample_bilinear",
                "split_bilinear", "quantize", "downsample"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_matches_the_jax_runtime(name, tmp_path):
    """The port's library and the JAX package's, built from the same C++
    code, give the same bytes on the same seeded inputs."""
    assert jnative.available()
    rng = np.random.default_rng(ENTRY_POINTS.index(name) + 100)
    if name == "scan_requests":
        _cross_scan(rng)
    elif name == "residency":
        _cross_residency(rng)
    elif name == "io_pool":
        _cross_io_pool(rng, tmp_path)
    elif name in ("taylor_spherical", "taylor_from_world", "project_view_uv"):
        _cross_taylor(rng, name)
    elif name == "view_anchors":
        _cross_view_anchors(rng)
    else:
        _cross_preprocess(rng, name)


def test_every_entry_point_is_counted_and_crossed():
    names = {n.split(".")[0] for n in native.counts()}
    assert names == {"scan_requests", "NativeResidency", "NativeIoPool", "taylor_spherical",
                     "taylor_from_world", "project_view_uv", "view_anchors",
                     "sample_bilinear", "split_bilinear", "quantize", "downsample"}
    assert names - {"NativeResidency", "NativeIoPool"} < set(ENTRY_POINTS)


# -- 3. the build --------------------------------------------------------------------


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"])
def test_a_failed_build_raises(cxx, tmp_path, monkeypatch):
    """A compiler that fails or is missing raises with its message, from the
    build and from every entry point's first load; BT_DISABLE_NATIVE=1
    alone turns the optional branches off, without a build."""
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    match = "false failed" if cxx == "false" else "cannot run"
    with pytest.raises(RuntimeError, match=match):
        native.build_library()
    assert not list(tmp_path.glob("*.so"))
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.raises(RuntimeError, match=match):
        native.NativeResidency(4, 1)
    with pytest.raises(RuntimeError, match=match):
        TileAtlasState(4, 1, [])
    monkeypatch.setenv("BT_DISABLE_NATIVE", "1")
    assert native.available() is False
    assert TileAtlasState(4, 1, [])._native is None
    assert native._lib is None


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Four processes build into one empty directory at once (as test
    workers do): one compiles, the others wait on the lock, and all load the
    same library."""
    script = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from bevy_terrain_tpu_torch import native
        native._BUILD_DIR = Path({str(tmp_path)!r})
        path = native.build_library()
        ctypes.CDLL(str(path))
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))
    # the flag that keeps the f64 chains bit-identical to the numpy oracles
    assert "-ffp-contract=off" in native.CXXFLAGS


# -- 4. the slice: both Terrains on their native runtimes ----------------------------


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _keys(tiles):
    return sorted((c.side, c.lod, c.x, c.y) for c in tiles)


SLICE = {
    # a deep planar quadtree (6 geometry lods over 3 data lods) under a
    # camera descending from 600 m to 30 m across the terrain
    "flythrough": dict(
        model=("planar", (np.zeros(3), 1000.0, 0.0, 100.0)),
        att=dict(name="height", texture_size=512, border_size=2, mip_level_count=4),
        terrain=dict(lod_count=6, atlas_size=128, path="terrains/fly"),
        view=dict(tile_capacity=512, morph_distance=4.0, blend_distance=1.5),
        # the fused kernel blends per vertex, the JAX staged path so too
        view_kw=dict(queue_capacity=2048, culling=True, blend_per_vertex=True),
        path=lambda s: np.stack([-300.0 + 500.0 * s, 600.0 * (1.0 - s) ** 2 + 30.0,
                                 250.0 - 400.0 * s], axis=-1),
        frames=6, tol=dict(heights=2e-2, positions=2e-2, uvs=1e-6)),
    # a small planet (6 geometry lods over 3 data lods of 256^2), descending
    # from 150 km to 20 km while crossing ~500 km: the Taylor chain every frame
    "planet": dict(
        model=("sphere", (np.zeros(3), 6.371e6, 0.0, 9000.0)),
        att=dict(name="height", texture_size=256, border_size=2, mip_level_count=3),
        terrain=dict(lod_count=6, atlas_size=128, path="terrains/planet"),
        view=dict(tile_capacity=512),
        view_kw=dict(queue_capacity=1024, culling=True, high_precision=False),
        path=lambda s: _unit(np.array([0.3, 0.2, 0.93]) * (1.0 - s[:, None])
                             + np.array([0.24, 0.28, 0.93]) * s[:, None])
        * (6.371e6 + 150_000.0 - 130_000.0 * s[:, None]),
        frames=4, tol=dict(heights=1e-1, positions=3.0, uvs=1e-6, normals=1e-5)),
}


@pytest.mark.parametrize("scene", sorted(SLICE))
def test_terrain_matches_the_jax_terrain_frame_by_frame(scene, tmp_path, monkeypatch,
                                                        jax_and_port_loads_in_step):
    from bevy_terrain_tpu_torch.config import AttachmentConfig
    from bevy_terrain_tpu_torch.math import frustum
    from bevy_terrain_tpu_torch.utils.synthetic import (
        generate_planar_dataset, generate_spherical_dataset,
    )
    from tests.test_torch_staged_pipeline import _assert_same_frame, _terrains

    monkeypatch.delenv("BT_DISABLE_NATIVE", raising=False)
    case = SLICE[scene]
    generate = generate_planar_dataset if scene == "flythrough" else generate_spherical_dataset
    generate(case["terrain"]["path"], 3, AttachmentConfig(**case["att"]), root=str(tmp_path))
    native.reset_counts()
    port, jax_t = _terrains(tmp_path, case["model"], [case["att"]], case["terrain"],
                            case["view"], case["view_kw"])
    assert port.atlas.state._native is not None and jax_t.atlas.state._native is not None
    path = case["path"](np.linspace(0.0, 1.0, case["frames"]))
    loaded = 0
    for i, view in enumerate(path):
        target = view * 0.5 if scene == "planet" else path[min(i + 1, len(path) - 1)] \
            + np.array([1.0, -0.2, 0.0])
        proj = {"cam": frustum.view_projection(view, target, np.pi / 3, 16 / 9)}
        out = port.update({"cam": view}, proj)["cam"]
        jout = jax_t.update({"cam": view}, proj)["cam"]
        tree, jtree = port.tile_trees["cam"], jax_t.tile_trees["cam"]
        assert jtree._native_scan is True
        assert _keys(tree.requested_tiles) == _keys(jtree.requested_tiles), i
        assert _keys(tree.released_tiles) == _keys(jtree.released_tiles), i
        np.testing.assert_array_equal(tree.entries, jtree.entries, err_msg=str(i))
        np.testing.assert_array_equal(port.last_uniform_blob("cam"),
                                      np.asarray(jax_t._last_uniforms["cam"]),
                                      err_msg=f"frame {i}: uniforms (Taylor included)")
        if out.tile_count > 6:
            _assert_same_frame(out, jout, case["tol"], view)
        loaded = max(loaded, sum(s.loading_remaining == 0
                                 for s in port.atlas.state.tile_states.values()))
    assert loaded > 5 and out.tile_count > 6
    calls = native.counts()
    used = ["scan_requests", "view_anchors", "NativeResidency.request",
            "NativeResidency.release", "NativeResidency.loaded", "NativeResidency.best_tiles",
            "sample_bilinear"]
    used += ["taylor_from_world", "project_view_uv"] if scene == "planet" else []
    assert all(calls[n] > 0 for n in used), {n: calls[n] for n in used}
