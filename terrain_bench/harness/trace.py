"""Reading a profiler trace of traced frames.

Each traced frame launches a marker kernel (``torch.cuda._sleep``'s spin
kernel, about a microsecond) before its update and another before its
render, and ends in a synchronize. The device records between marker 2j
and 2j + 1 are frame j's update, those up to marker 2j + 2 its render. On
the card's machine the records of a trace's first and last calls can be
missing, so the first frame and the tail frames are traced and not read.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from harness import stats

MARK_CYCLES = 1000
SPIN = "spin_kernel"


def mark() -> None:
    torch.cuda._sleep(MARK_CYCLES)


def records(prof):
    """(device records [(start us, end us, name)], host records [(start us,
    end us, name)]) of a trace: kernels, copies and fills on the device;
    ops and ranges on the host."""
    from torch.autograd import DeviceType

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    dev, host = [], []
    for e in result.events():
        if e.start_ns() < t0:
            continue
        r = (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append(r)
        elif e.device_type() == DeviceType.CPU:
            host.append(r)
    return dev, host


def split_frames(dev: list, n_read: int) -> list:
    """([{"update": [...], "render": [...]}] of frames 1 .. n_read, by the
    markers (frame 0 is not read), and the window (start us, end us) from
    frame 1's first marker to the marker after frame n_read)."""
    marks = sorted(s for s, _, name in dev if SPIN in name)
    need = 2 * (n_read + 1) + 1
    if len(marks) < need:
        raise RuntimeError(f"the trace holds {len(marks)} of the {need} markers it needs")
    body = [r for r in dev if SPIN not in r[2]]
    frames = []
    for j in range(1, n_read + 1):
        a, b, c = marks[2 * j], marks[2 * j + 1], marks[2 * j + 2]
        frames.append({"update": [r for r in body if a < r[0] < b],
                       "render": [r for r in body if b < r[0] < c]})
    return frames, (marks[2], marks[2 * n_read + 2])


def busy(dev: list, window: tuple) -> float:
    """Device-busy microseconds in ``window``: the union of every record
    but the markers."""
    return stats.union_busy([(s, e) for s, e, n in dev if SPIN not in n], *window)


def short(name: str, width: int = 120) -> str:
    """A device op's name without ``void`` and its argument list, cut to
    ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def top_ops(dev: list, window: tuple, n: int = 10) -> list:
    """[[name, seconds]] of the device ops with the most time in the
    window, largest first."""
    t = collections.defaultdict(float)
    for s, e, name in dev:
        if SPIN not in name and window[0] <= s < window[1]:
            t[short(name)] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(t.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(mids, recs):
    """For each of the sorted midpoints ``mids``, the index into ``recs``
    [(start, end, name)] of the shortest record holding it, or -1."""
    best = np.full(len(mids), np.inf)
    idx = np.full(len(mids), -1)
    for i, (s, e, _) in enumerate(recs):
        lo, hi = np.searchsorted(mids, s), np.searchsorted(mids, e, side="right")
        if hi > lo:
            seg = best[lo:hi] > (e - s)
            best[lo:hi] = np.where(seg, e - s, best[lo:hi])
            idx[lo:hi] = np.where(seg, i, idx[lo:hi])
    return idx


def idle_by_host(dev: list, host: list, window: tuple, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the device's idle time in the
    window, largest first: each idle gap's time given to the innermost host
    record that holds the gap's midpoint, named with the benchmark's range
    (``tb::...``) around it."""
    intervals = [(s, e) for s, e, name in dev if SPIN not in name]
    holes = stats.gaps(intervals, *window)
    if not holes:
        return []
    mids = np.array([0.5 * (s + e) for s, e in holes])
    ranges = [h for h in host if h[2].startswith("tb::")]
    ops = [h for h in host if not h[2].startswith("tb::")]
    outer, inner = _innermost(mids, ranges), _innermost(mids, ops)
    t = collections.defaultdict(float)
    for (s, e), o, i in zip(holes, outer, inner):
        label = (ranges[o][2] if o >= 0 else "tb::none") + " / " + (ops[i][2] if i >= 0 else "none")
        t[label] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(t.items(), key=lambda kv: -kv[1])[:n]]
