"""Spans and counters of the frame, on the profiler's clock.

The frame's phases open spans named ``<layer>::<phase>``::

    with tracing.span("stage::refine"):
        ...
    tracing.count("refine_reads")

Tracing is on while a torch profiler records, or inside :func:`record`
(the operator's switch, no profiler needed). Off, :func:`span` checks a
flag and the profiler's state and hands back one shared no-op context:
no profiler range, no CUDA event, nothing kept; :func:`count` does
nothing. On, a span opens a ``torch.profiler.record_function`` range of its
name (so it lies in the profiler's trace beside the device records),
stamps ``time.time_ns()`` at entry and exit (the clock the profiler stamps
its records with, Unix-epoch nanoseconds), records a CUDA event pair on
the current stream when its frame runs on a CUDA device, and keeps all of
it in its frame's record.

Frame records: ``Terrain.update`` opens one, keyed by the terrain's
``frame_index`` (``span(..., frame=k, device=...)``), and
``Terrain.render_image`` joins the newest (``frame=LAST``); a span inside a
recorded span goes to its frame; a span outside any frame opens its
profiler range only. The last :data:`RING` frames are kept. :func:`frames`
reads them.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

RING = 64
LAST = "last"  # span(..., frame=LAST): join the newest frame record

_recording = 0  # depth of open record() contexts
_frames: collections.deque = collections.deque(maxlen=RING)
_open: list = []  # the recorded spans now open, innermost last
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans and counters record: inside :func:`record`, or while
    a torch profiler records."""
    return _recording > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def record():
    """Turn tracing on for the block, with no profiler running."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


class _Frame:
    __slots__ = ("index", "device", "spans", "counters")

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.spans: list = []
        self.counters: collections.Counter = collections.Counter()


class _Span:
    __slots__ = ("name", "parent", "frame", "new_frame", "device", "start_ns", "end_ns",
                 "events", "device_ms", "_range")

    def __init__(self, name: str, frame, device):
        self.name = name
        self.new_frame = frame
        self.device = device
        self.frame = None
        self.parent = None
        self.start_ns = self.end_ns = None
        self.events = None
        self.device_ms = None

    def _join(self):
        """The frame record this span goes to, or None."""
        if _open:
            self.parent = _open[-1].name
            return _open[-1].frame
        if self.new_frame == LAST:
            return _frames[-1] if _frames else None
        if self.new_frame is None:
            return None
        if not _frames or _frames[-1].index != self.new_frame:
            _frames.append(_Frame(self.new_frame, torch.device(self.device or "cpu")))
        return _frames[-1]

    def __enter__(self):
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        self.frame = self._join()
        self.start_ns = time.time_ns()
        if self.frame is not None:
            if self.frame.device.type == "cuda":
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record(torch.cuda.current_stream(self.frame.device))
            self.frame.spans.append(self)
            _open.append(self)
        return self

    def __exit__(self, *exc):
        if self.frame is not None:
            if self.events is not None:
                self.events[1].record(torch.cuda.current_stream(self.frame.device))
            _open.pop()
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        return False

    def as_dict(self) -> dict:
        if self.events is not None:
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None
        return {"name": self.name, "parent": self.parent,
                "host_ms": (self.end_ns - self.start_ns) / 1e6, "device_ms": self.device_ms,
                "start_ns": self.start_ns, "end_ns": self.end_ns}


def span(name: str, frame=None, device=None):
    """A span of the frame (module docstring). ``frame``: the frame index a
    top-level span opens (or joins, when the newest record has it) on
    ``device``, or :data:`LAST` to join the newest record; a nested span
    takes its enclosing span's frame."""
    if not enabled():
        return _OFF
    return _Span(name, frame, device)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the frame of the innermost open
    span, when tracing is on. ``n``: an int, or a 0-d integer tensor, which
    stays unread (no host sync) until :func:`frames`."""
    if _open and enabled():
        counters = _open[-1].frame.counters
        counters[name] = counters[name] + (n if isinstance(n, torch.Tensor) else int(n))


def frames() -> list:
    """The recorded frames, oldest first, after one synchronize of the
    card: ``{"index", "counters": {name: int}, "spans": [{"name", "parent"
    (the enclosing span's name or None), "host_ms", "device_ms" (the CUDA
    event pair's, None off the card), "start_ns", "end_ns" (time.time_ns
    at entry and exit)}]}``, spans in the order they opened (those still
    open are left out)."""
    for dev in {f.device for f in _frames if f.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    for f in _frames:  # the tensor counts, read once
        for name, n in f.counters.items():
            if isinstance(n, torch.Tensor):
                f.counters[name] = int(n)
    return [{"index": f.index, "counters": dict(f.counters),
             "spans": [s.as_dict() for s in f.spans if s.end_ns is not None]}
            for f in _frames]
