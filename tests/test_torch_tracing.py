"""The frame's tracing spans and counters (``utils/tracing.py``) on the CPU.

A tiny synthetic planar scene (2 data lods of 128^2 R16 heights 0-5 m and
an Rgba8 albedo; grid size 8, so the staged mesh and the staged material
run; a camera 8 m up, so refinement's spill loop runs two levels past the
dense ones; a 48^2 image):

* with tracing off a frame opens no profiler range, makes no CUDA event
  and records nothing, and its products are bit-equal to a frame with
  tracing on;
* under ``tracing.record()`` and under a CPU ``torch.profiler`` every span
  of the frame opens once, nested as the pipeline nests them, and each
  span's ``time.time_ns`` stamps lie within 1 ms of the profiler's record
  of the same range;
* ``refine_reads`` equals the spill loop's iterations plus its final read,
  counted from the calls of ``should_be_divided`` (once for the dense
  levels, once an iteration);
* ``tiles_requested``, ``tiles_loaded`` and ``upload_bytes`` while the
  scene streams in;
* a span of a CUDA frame records an event pair (fake events, so on the
  CPU), and the ring keeps the last 64 frames.
"""

import collections
import time

import numpy as np
import pytest
import torch

from bevy_terrain_tpu_torch.config import (
    AttachmentConfig, AttachmentFormat, TerrainConfig, TerrainViewConfig,
)
from bevy_terrain_tpu_torch.math import TerrainModel, frustum
from bevy_terrain_tpu_torch.ops import refinement
from bevy_terrain_tpu_torch.render import material as mat
from bevy_terrain_tpu_torch.render.pipeline import Terrain
from bevy_terrain_tpu_torch.utils import tracing
from bevy_terrain_tpu_torch.utils.synthetic import generate_planar_dataset
from torch_raster_cases import binned_case

# span -> its enclosing span, for every span of a frame of the scene
NESTING = {
    "terrain::update": None,
    "update::requests": "terrain::update",
    "update::residency": "terrain::update",
    "update::uniforms": "terrain::update",
    "stage::refine": "terrain::update",
    "stage::mesh": "terrain::update",
    "stage::material": "terrain::update",
    "terrain::render": None,
    "raster::bin_sort": "terrain::render",
    "raster::scan": "terrain::render",
    "raster::resolve": "terrain::render",
    "raster::shade": "terrain::render",
}
VIEW = np.array([0.0, 8.0, 0.0])
VP = frustum.view_projection(VIEW, np.array([300.0, 0.0, 200.0]), np.radians(60.0), 1.0,
                             near=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(terrain):
    out = terrain.update({"cam": VIEW}, {"cam": VP})["cam"]
    image, _ = terrain.render_image("cam", out, VP, 48, 48, bin_px=8, bin_cap=128)
    return out, image


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(the terrain, its streaming frames' records, the data bytes of its
    tile attachments' first mips, its tile attachments), streamed in
    under ``tracing.record()``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("torch_tracing"))
    h = dict(name="height", texture_size=128, border_size=2, mip_level_count=2)
    atts = (AttachmentConfig(**h),
            AttachmentConfig(**{**h, "name": "albedo"}, format=AttachmentFormat.RGBA8))
    for a in atts:
        generate_planar_dataset("tracing", 2, a, root=root)
    config = TerrainConfig(lod_count=2, model=TerrainModel.planar(np.zeros(3), 1000.0, 0.0, 5.0),
                           atlas_size=16, path="tracing", attachments=atts, assets_root=root)
    terrain = Terrain(config, device="cpu")
    terrain.add_view("cam", TerrainViewConfig(tile_capacity=256, morph_distance=4.0,
                                              grid_size=8),
                     queue_capacity=512, culling=True)
    terrain.set_shading(mat.StandardMaterial(base_color=mat.albedo_material(1)),
                        sample_attachments=(1,))
    first = terrain.frame_index
    with tracing.record():
        for i in range(100):
            _frame(terrain)
            if i > 1 and not terrain.atlas.state.to_load and not any(
                    a.loading or a._staged for a in terrain.atlas.attachments):
                break
            time.sleep(0.01)
    frames = [f for f in tracing.frames() if f["index"] >= first]
    data = sum(a.data[s.atlas_index].nbytes for a in terrain.atlas.attachments
               for s in terrain.atlas.state.tile_states.values())
    n_tiles = len(terrain.atlas.state.tile_states) * len(atts)
    torch.set_num_threads(threads)
    return terrain, frames, data, n_tiles


def _newest(n):
    return tracing.frames()[-n:]


def test_a_frame_off_records_nothing_and_equals_a_frame_on(scene, monkeypatch):
    terrain = scene[0]
    with tracing.record():
        out_on, image_on = _frame(terrain)
    before = _newest(1)[0]["index"]
    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: opened.append("event"))
    assert not tracing.enabled()
    out_off, image_off = _frame(terrain)
    assert not opened
    assert _newest(1)[0]["index"] == before
    assert torch.equal(image_off, image_on)
    assert out_off.tile_count == out_on.tile_count
    for a, b in ((out_off.mesh.positions, out_on.mesh.positions),
                 (out_off.colors, out_on.colors)):
        assert torch.equal(a, b)


def _check_frame(frame):
    names = [s["name"] for s in frame["spans"]]
    assert sorted(names) == sorted(NESTING), names
    assert {s["name"]: s["parent"] for s in frame["spans"]} == NESTING
    by = {s["name"]: s for s in frame["spans"]}
    for s in frame["spans"]:
        assert s["device_ms"] is None  # no event pair off the card
        assert s["end_ns"] >= s["start_ns"] and s["host_ms"] >= 0
        p = by.get(s["parent"])
        if p is not None:
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    assert by["terrain::update"]["end_ns"] <= by["terrain::render"]["start_ns"]


def test_every_span_opens_once_a_frame_under_record(scene):
    with tracing.record():
        _frame(scene[0])
    _check_frame(_newest(1)[0])


def test_every_span_opens_once_a_frame_under_the_profiler_on_its_clock(scene):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _frame(scene[0])  # tracing off: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        _frame(scene[0])
    assert not tracing.enabled()
    frame = _newest(1)[0]
    _check_frame(frame)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() in NESTING}
    assert set(ranges) == set(NESTING)
    for s in frame["spans"]:
        r = ranges[s["name"]]
        assert abs(s["start_ns"] - r.start_ns()) < 1e6, s["name"]
        assert abs(s["end_ns"] - (r.start_ns() + r.duration_ns())) < 1e6, s["name"]


def test_refine_reads_counts_the_spill_loops_reads(scene, monkeypatch):
    calls = []
    real = refinement.should_be_divided
    monkeypatch.setattr(refinement, "should_be_divided",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with tracing.record():
        _frame(scene[0])
    cfg = scene[0]._static_cfgs["cam"]
    iterations = len(calls) - 1
    assert iterations >= 2  # the camera takes the loop past the dense levels
    k_end = refinement.dense_level_cap(cfg) + 1 + 2 * iterations
    final = k_end < cfg.refinement_count  # the loop ended on an empty queue
    assert _newest(1)[0]["counters"]["refine_reads"] == iterations + final


def test_streaming_counts_requests_loads_and_upload_bytes(scene):
    terrain, frames, data, n_tiles = scene
    blob = terrain.last_uniform_blob("cam").nbytes
    counters = [f["counters"] for f in frames]
    assert counters[0]["tiles_requested"] > 0 and counters[-1].get("tiles_requested", 0) == 0
    assert sum(c.get("tiles_loaded", 0) for c in counters) == n_tiles
    for c in counters:
        if c.get("tiles_loaded", 0):
            assert c["upload_bytes"] > blob
        else:
            assert c["upload_bytes"] == blob
    assert sum(c["upload_bytes"] - blob for c in counters) > data


class _FakeEvent:
    recorded = []

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.at = len(_FakeEvent.recorded)
        _FakeEvent.recorded.append(stream)

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_a_cuda_frame_records_an_event_pair_a_span_only_when_on(monkeypatch):
    synced = []
    monkeypatch.setattr(tracing, "_frames", collections.deque(maxlen=tracing.RING))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: ("stream", device.type))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: synced.append(device))
    _FakeEvent.recorded = []

    def frame(index):
        with tracing.span("terrain::update", frame=index, device="cuda"):
            with tracing.span("stage::refine"):
                tracing.count("refine_reads", 2)

    frame(-7)
    assert _FakeEvent.recorded == []
    with tracing.record():
        frame(-8)
    assert _FakeEvent.recorded == [("stream", "cuda")] * 4
    got = _newest(1)[0]
    assert synced == [torch.device("cuda")]
    assert got["index"] == -8 and got["counters"] == {"refine_reads": 2}
    assert [(s["name"], s["device_ms"]) for s in got["spans"]] == [
        ("terrain::update", 3.0), ("stage::refine", 1.0)]


def test_the_ring_keeps_the_last_64_frames(monkeypatch):
    monkeypatch.setattr(tracing, "_frames", collections.deque(maxlen=tracing.RING))
    with tracing.record():
        for i in range(tracing.RING + 6):
            with tracing.span("terrain::update", frame=1000 + i, device="cpu"):
                with tracing.span("update::requests"):
                    pass
        with tracing.span("terrain::render", frame=tracing.LAST):
            pass
    frames = tracing.frames()
    assert len(frames) == tracing.RING
    assert [f["index"] for f in frames] == list(range(1006, 1006 + tracing.RING))
    assert [s["name"] for s in frames[-1]["spans"]] == [
        "terrain::update", "update::requests", "terrain::render"]
    # a top-level span without a frame opens its range only
    with tracing.record(), tracing.span("raster::scan"):
        tracing.count("refine_reads")
    assert tracing.frames()[-1] == frames[-1]


def test_count_keeps_a_tensor_unread_until_frames(monkeypatch):
    monkeypatch.setattr(tracing, "_frames", collections.deque(maxlen=tracing.RING))
    with monkeypatch.context() as m:
        for read in ("item", "tolist", "__int__", "__index__", "__bool__", "__float__"):
            m.setattr(torch.Tensor, read, lambda *a, **k: pytest.fail("a host read"))
        with tracing.record(), tracing.span("terrain::render", frame=3, device="cpu"):
            tracing.count("scan_candidates", torch.tensor(5))
            tracing.count("scan_candidates", 2)
            tracing.count("scan_candidates", torch.tensor(3, dtype=torch.int64))
            tracing.count("scan_slots", 40)
        held = tracing._frames[-1].counters
        assert isinstance(held["scan_candidates"], torch.Tensor)
    assert tracing.frames()[-1]["counters"] == {"scan_candidates": 10, "scan_slots": 40}
    assert type(tracing.frames()[-1]["counters"]["scan_candidates"]) is int


# -- the raster scan's candidate table (csrc/raster_scan.cu's walk) -----------------


RASTER_CASES = ["flat", "bumpy", "seam", "grazing", "near", "overflow"]


@pytest.mark.parametrize("name", RASTER_CASES)
def test_every_table_segment_is_a_dense_prefix(name):
    """What the scan kernel walks: each level segment of a row of the
    table is a prefix of triangle ids followed by -1, and the columns past
    the last segment are -1."""
    b, _, k = binned_case(name)
    table, T = b.table.numpy(), b.coefs.shape[0]
    starts = np.concatenate([[0], np.cumsum(b.grid.caps)])
    assert table.shape[1] == -(-starts[-1] // k["chunk"]) * k["chunk"]
    assert (table[:, starts[-1]:] == -1).all()
    assert ((table == -1) | ((table >= 0) & (table < T))).all()
    for s0, s1 in zip(starts[:-1], starts[1:]):
        live = table[:, s0:s1] >= 0
        assert not (live[:, 1:] & ~live[:, :-1]).any()
    assert (table >= 0).any()


def _walk(b, bin_px, chunk):
    """The scan as csrc/raster_scan.cu walks the table, in numpy f32: each
    row's segments in column order up to the first -1, a running winner of
    each group of ``chunk`` columns (first maximum, a NaN depth wins and
    sticks), folded into the best when the group changes if strictly
    greater."""
    table, coefs, tl = b.table.numpy(), b.coefs.numpy(), b.top_left.numpy()
    starts = np.concatenate([[0], np.cumsum(b.grid.caps)])
    NB, P = table.shape[0], bin_px * bin_px
    best_z = np.full((NB, P), -np.inf, np.float32)
    best_t = np.full((NB, P), -1, np.int64)
    for n in range(NB):
        x, y = b.grid.pix_x[n, :, 0].numpy(), b.grid.pix_y[n, :, 0].numpy()
        bz, bt, gz, gt, group = best_z[n], best_t[n], best_z[n].copy(), best_t[n].copy(), -1

        def fold():
            better = gz > bz
            bz[better], bt[better] = gz[better], gt[better]
            gz[:] = -np.inf

        for s0, s1 in zip(starts[:-1], starts[1:]):
            for col in range(s0, s1):
                cand = table[n, col]
                if cand < 0:
                    break
                if col // chunk != group:
                    fold()
                    group = col // chunk
                a, bb, c = coefs[cand]
                planes = (a[None] * x[:, None] + bb[None] * y[:, None]) + c[None]
                e = planes[:, :3]
                inside = np.where(tl[cand][None], e >= 0, e > 0).all(-1)
                z = planes[:, 3]
                take = inside & ((z > gz) | np.isnan(z))
                gz[take], gt[take] = z[take], cand
        fold()
    return best_z, best_t


@pytest.mark.parametrize("name", RASTER_CASES + ["nan"])
def test_the_kernels_walk_equals_the_torch_scan(name):
    """Walking only the live prefixes, with the group rule, gives the torch
    scan's bits; with NaN coefficients too (case "nan")."""
    from bevy_terrain_tpu_torch.render import raster

    b, _, k = binned_case(name)
    want_z, want_t = raster._scan(b, k["bin_px"], k["chunk"])
    with np.errstate(invalid="ignore"):
        z, t = _walk(b, k["bin_px"], k["chunk"])
    assert (t >= 0).any()
    np.testing.assert_array_equal(z.view(np.int32), want_z.numpy().view(np.int32))
    np.testing.assert_array_equal(t, want_t.numpy())


@pytest.mark.parametrize("name", RASTER_CASES)
def test_scan_counters_read_the_table(name, monkeypatch):
    from bevy_terrain_tpu_torch.render import raster

    monkeypatch.setattr(tracing, "_frames", collections.deque(maxlen=tracing.RING))
    b, args, k = binned_case(name)
    raster.rasterize_grid(*args, **k)  # tracing off: counts nothing
    with tracing.record(), tracing.span("terrain::render", frame=0, device="cpu"):
        raster.rasterize_grid(*args, **k)
    counters = tracing.frames()[-1]["counters"]
    assert counters == {"scan_candidates": int((b.table >= 0).sum()),
                        "scan_slots": b.table.numel()}
    assert 0 < counters["scan_candidates"] <= counters["scan_slots"]
