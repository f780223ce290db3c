"""The readers of the program's tracing spans (``harness/spans.py``) on
synthetic records: read frames matched to program frames by time on the
shared clock, the idle gaps given to the innermost span holding their
midpoint, and None where the program, a match or a span is missing."""

import pytest

from harness import manifest, spans


def span(name, start_us, end_us, parent="terrain::update", host_ms=None, device_ms=None):
    return {"name": name, "parent": None if name.startswith("terrain::") else parent,
            "host_ms": (end_us - start_us) / 1e3 if host_ms is None else host_ms,
            "device_ms": device_ms, "start_ns": int(start_us * 1e3),
            "end_ns": int(end_us * 1e3)}


def program_frame(index, t0, refine_device=None, reads=3):
    """A frame opening at ``t0`` us: the prologue 0-10 us after it, refine
    10-20, mesh 20-25, the render 30-60."""
    return {"index": index, "counters": {"refine_reads": reads, "tiles_loaded": 0},
            "spans": [span("terrain::update", t0, t0 + 25),
                      span("update::requests", t0, t0 + 4),
                      span("update::uniforms", t0 + 4, t0 + 10),
                      span("stage::refine", t0 + 10, t0 + 20, device_ms=refine_device),
                      span("stage::mesh", t0 + 20, t0 + 25),
                      span("terrain::render", t0 + 30, t0 + 60),
                      span("raster::scan", t0 + 32, t0 + 58, parent="terrain::render",
                           device_ms=2.0 + index)]}


def read_frame(t0):
    """The device records of a frame whose update opened at ``t0`` (us
    after it): idle 0-6 (midpoint 3, in update::requests), busy 6-8, idle
    8-16 (midpoint 12, in stage::refine), busy 16-22, idle 22-40 (midpoint
    31, in terrain::render outside raster::scan), busy 40-50."""
    return {"update": [(t0 + 6, t0 + 8, "k_a"), (t0 + 16, t0 + 22, "k_b")],
            "render": [(t0 + 40, t0 + 50, "k_c")]}


@pytest.fixture
def program(monkeypatch):
    frames = [program_frame(i, 1000.0 * i) for i in range(5)]
    monkeypatch.setattr(spans, "program_frames", lambda: frames)
    return frames


def test_read_frames_are_matched_by_time_not_position(program):
    read = [read_frame(3000.0), read_frame(1000.0)]
    got = spans.match(read, program)
    assert [f["index"] for f in got] == [3, 1]
    # shuffled program frames: the same match
    assert [f["index"] for f in spans.match(read, program[::-1])] == [3, 1]
    # a read frame that starts before every program frame has none
    assert spans.match([read_frame(-500.0)], program) is None
    # a record late by a whole frame would hand two read frames one program frame
    assert spans.match([read_frame(2000.0), read_frame(2100.0)], program) is None
    # only a top-level terrain::update opens a frame
    nested = [dict(program[0], spans=[dict(s, parent="x") for s in program[0]["spans"]])]
    assert spans.match([read_frame(0.0)], nested) is None


def test_span_and_counter_readers(program):
    t = {"frames": [read_frame(1000.0), read_frame(2000.0), read_frame(4000.0)]}
    assert spans.span_ms(t, "stage::refine") == pytest.approx(0.01)
    assert spans.span_ms(t, "raster::scan", "device_ms") == 4.0  # frames 1, 2, 4
    assert spans.counter(t, "refine_reads") == 3.0
    assert spans.counter(t, "tiles_requested") == 0.0
    # a span that never opened, and device times of a span off the card
    assert spans.span_ms(t, "stage::material") is None
    assert spans.span_ms(t, "stage::refine", "device_ms") is None


def test_idle_gaps_go_to_the_innermost_span_at_their_midpoint(program):
    t = {"frames": [read_frame(1000.0), read_frame(2000.0)]}
    assert spans.idle_ms(t, "update::") == pytest.approx(6.0 / 1e3)
    assert spans.idle_ms(t, "stage::") == pytest.approx(8.0 / 1e3)
    assert spans.idle_ms(t, "terrain::render") == pytest.approx(18.0 / 1e3)
    assert spans.idle_ms(t, "raster::") == 0.0


def test_every_reader_is_none_without_the_programs_tracing(monkeypatch):
    monkeypatch.setattr(spans, "program_frames", lambda: None)
    t = {"frames": [read_frame(0.0)]}
    names = ["prologue_ms.requests", "prologue_ms.residency", "prologue_ms.uniforms",
             "stage_ms.refine", "stage_ms.mesh", "stage_ms.material", "refine_reads",
             "raster_ms.bin_sort", "raster_ms.scan", "raster_ms.shade", "idle_ms.prologue",
             "idle_ms.stage"]
    assert [manifest.module("metrics", n).read(t) for n in names] == [None] * len(names)


def test_program_frames_is_none_where_the_module_is_missing(monkeypatch):
    """As in a program without ``utils/tracing.py``."""
    import importlib
    import sys

    utils = importlib.import_module("bevy_terrain_tpu_torch.utils")
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "bevy_terrain_tpu_torch.utils.tracing", None)
    assert spans.program_frames() is None
