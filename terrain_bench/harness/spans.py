"""The program's tracing spans and counters beside the traced frames'
device records.

The program keeps a record of its last frames (``bevy_terrain_tpu_torch
.utils.tracing``): each span's ``time.time_ns()`` at entry and exit, its
host and CUDA-event milliseconds, and the frame's counters. The profiler
stamps its records on the same clock (Unix-epoch time), so a read frame is
matched to its program frame by time, never by position: the frame whose
``terrain::update`` span opened last before the read frame's first update
record. A reader gets None where the program has no such record (a
program without ``utils.tracing``), where a read frame has no program frame
or two read frames share one, or where the span never opened in the read
frames.
"""

from __future__ import annotations

import numpy as np

from harness import layers, stats, trace

FRAME = "terrain::update"


def program_frames():
    """The program's recorded frames, or None without its tracing module."""
    try:
        from bevy_terrain_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.frames()


def match(read: list, program: list):
    """[the program frame of each read frame] (module docstring), or None."""
    opens = sorted(((s["start_ns"] / 1e3, i) for i, f in enumerate(program)
                    for s in f["spans"] if s["name"] == FRAME and s["parent"] is None))
    starts = np.array([t for t, _ in opens])
    out = []
    for f in read:
        if not f["update"]:
            return None
        k = int(np.searchsorted(starts, min(s for s, _, _ in f["update"]))) - 1
        if k < 0:
            return None
        out.append(opens[k][1])
    if len(set(out)) != len(out):
        return None
    return [program[i] for i in out]


def matched(t: dict):
    """(read frames, their program frames) of a trace, or None."""
    program = program_frames()
    if program is None:
        return None
    frames = match(t["frames"], program)
    return None if frames is None else (t["frames"], frames)


def span_ms(t: dict, name: str, kind: str = "host_ms"):
    """The median over the read frames of span ``name``'s ``kind``
    (``host_ms`` or ``device_ms``), summed over its openings in a frame
    (0 in a frame where it did not open); None where it never opened."""
    m = matched(t)
    if m is None:
        return None
    per_frame = [[s[kind] for s in f["spans"] if s["name"] == name] for f in m[1]]
    if not any(per_frame) or any(v is None for ms in per_frame for v in ms):
        return None
    return layers.median([sum(ms) for ms in per_frame])


def counter(t: dict, name: str):
    """The median over the read frames of counter ``name`` (0 in a frame
    that did not count it)."""
    m = matched(t)
    return None if m is None else layers.median([f["counters"].get(name, 0) for f in m[1]])


def idle_ms(t: dict, prefix: str):
    """The median over the read frames of the device-idle ms in gaps whose
    midpoint the innermost program span holding it names ``prefix...``
    (``trace.idle_by_host``'s rule). A frame's gaps lie between its
    ``terrain::update`` span's start and its last device record's end,
    among its update and render records."""
    m = matched(t)
    if m is None:
        return None
    out = []
    for rf, pf in zip(*m):
        recs = rf["update"] + rf["render"]
        spans = [(s["start_ns"] / 1e3, s["end_ns"] / 1e3, s["name"]) for s in pf["spans"]]
        lo = min(s for s, _, n in spans if n == FRAME)
        holes = stats.gaps([(s, e) for s, e, _ in recs], lo, max(e for _, e, _ in recs))
        mids = np.array([0.5 * (s + e) for s, e in holes])
        inner = trace._innermost(mids, spans) if holes else []
        out.append(sum(e - s for (s, e), i in zip(holes, inner)
                       if i >= 0 and spans[i][2].startswith(prefix)) / 1e3)
    return layers.median(out)
