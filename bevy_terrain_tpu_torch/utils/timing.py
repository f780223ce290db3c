"""Timing harness: device time on the card, and honest wall time.

Torch twin of the JAX package's ``utils/timing.py``. PyTorch returns from a
CUDA call before the card has run it, so a host clock around a call
measures its launches, not its work. The helpers:

* :func:`device_time_ms`: the CUDA kernels' own time per call, from
  ``torch.profiler`` (the JAX module reads the jit event of a profiler
  trace). Use for benchmarks.
* :func:`benchmark`: host wall time per call with a
  ``torch.cuda.synchronize()`` after each on the card (the JAX module
  fetches an output byte instead). Slightly pessimistic: it adds one sync.
* :func:`device_breakdown`: the same kernels' time by name, per call
  (the census tools' top ops).
* :func:`cuda_ms`, :func:`device_ms`, :func:`cold_ms`: CUDA-event times of
  a call (stream span; back to back behind a sleep kernel; with the L2
  flushed before each launch).

The frame's own phases are tracing spans (``utils/tracing.py``).

No helper here falls back to the host clock on a process without a card:
the device helpers raise there.
"""

from __future__ import annotations

import collections
import statistics
import time

import numpy as np
import torch


def _need_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times the CUDA card, and this process has none")


def device_events(prof):
    """The profiler's per-name averages of the kernels on the card. An aten
    op's entry carries its kernels' device time too, so a sum over every
    entry counts each kernel twice; user annotations (``record_function``
    ranges, such as the tracing spans) are spans, not kernels."""
    from torch.autograd import DeviceType

    spans = {e.name for e in prof.events() if e.is_user_annotation}
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in spans]


# device_time_ms brackets each call by a marker kernel (torch.cuda._sleep's
# spin kernel, about a microsecond) and reads the calls between markers. On
# the card's machine the last call of a trace has come back without its
# device records (its markers present; the records arrived in a later
# trace), so one more call follows the calls read, then more markers; the
# records that started before the trace are dropped, and a trace whose
# calls read differ in record count is taken again
_MARK_CYCLES, _TAIL_MARKS, _TRACES = 1000, 16, 3


def _between_markers(records, runs: int, label: str) -> list:
    """The records of each of ``runs`` calls: those between marker ``i``
    and marker ``i + 1``. ``records`` are (start us, duration us, is a
    marker, ...) of one trace's device records. Raises when a marker is
    missing, a call holds no record, or the calls hold different numbers of
    records."""
    marks = sorted(r[0] for r in records if r[2])
    if len(marks) < runs + 1:
        raise RuntimeError(f"{label}: the trace holds {len(marks)} of the {runs + 1} markers "
                           "around the calls")
    calls = [[r for r in records if not r[2] and marks[i] < r[0] < marks[i + 1]]
             for i in range(runs)]
    counts = [len(c) for c in calls]
    if not all(counts) or len(set(counts)) != 1:
        raise RuntimeError(f"{label}: the calls hold {counts} device records on the card")
    return calls


def _per_call_us(records, runs: int, label: str) -> list:
    """Device time (us) of each of ``runs`` calls: the summed durations of
    the records between marker ``i`` and marker ``i + 1``
    (:func:`_between_markers`)."""
    return [sum(r[1] for r in c) for c in _between_markers(records, runs, label)]


def _kernel_rows(calls, label: str) -> list:
    """[(name, launches per call, ms per call)], largest first, of calls
    whose records are (start us, duration us, is a marker, name). Raises
    when the calls launched different kernels."""
    per_call = [collections.Counter(r[3] for r in c) for c in calls]
    if any(p != per_call[0] for p in per_call):
        raise RuntimeError(f"{label}: the calls launched different kernels on the card")
    ms = collections.defaultdict(float)
    for c in calls:
        for r in c:
            ms[r[3]] += r[1] / len(calls) / 1e3
    return sorted(((name, n, ms[name]) for name, n in per_call[0].items()),
                  key=lambda r: -r[2])


def _device_records(prof) -> list:
    """(start us, duration us, name) of a profiler trace's records on the
    card that started inside the trace: kernels, copies and fills, not the
    user annotations (the tracing spans' ranges)."""
    from torch.autograd import DeviceType

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    return [(e.start_ns() / 1e3, e.duration_ns() / 1e3, e.name()) for e in result.events()
            if e.device_type() == DeviceType.CUDA and e.start_ns() >= t0
            and not e.is_user_annotation()]


def _traced_calls(fn, args, runs: int) -> list:
    """One profiler trace of ``runs + 1`` calls of ``fn(*args)``, each
    after a marker kernel and followed by a sync, then more markers: its
    device records as (start us, duration us, is a marker, name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(runs + 1 + _TAIL_MARKS):
            torch.cuda._sleep(_MARK_CYCLES)
            if i <= runs:  # the call after the ``runs`` read is not read
                fn(*args)
            torch.cuda.synchronize()
    return [(t, d, "spin_kernel" in name, name) for t, d, name in _device_records(prof)]


def device_time_ms(fn, *args, label: str = "bench", runs: int = 5) -> float:
    """Median over ``runs`` calls of ``fn(*args)`` of the CUDA kernels' self
    time in the call (ms), each kernel counted once: after one warm call,
    one profiler trace of ``runs + 1`` calls, the first ``runs`` read
    between marker kernels (:func:`_per_call_us`), the device records that
    :func:`device_events` counts (kernels, copies and fills; not the
    tracing spans' ranges).
    ``label`` names the measurement in errors. Raises without a card, and
    when a call runs no kernel on it."""
    _need_card("device_time_ms")
    fn(*args)  # first-use costs (kernel builds, allocator growth) stay outside
    torch.cuda.synchronize()
    for attempt in range(_TRACES):
        try:
            return float(np.median(_per_call_us(_traced_calls(fn, args, runs), runs,
                                                label))) / 1e3
        except RuntimeError:
            if attempt == _TRACES - 1:
                raise


def device_breakdown(fn, *args, label: str = "breakdown", runs: int = 5):
    """The CUDA kernels of ``fn(*args)`` by name, per call, read from the
    trace :func:`device_time_ms` reads (``runs`` calls between marker
    kernels, :func:`_kernel_rows`). Returns (device ms per call, [(name,
    launches per call, ms per call)] by time, largest first). Raises without
    a card."""
    _need_card("device_breakdown")
    fn(*args)
    torch.cuda.synchronize()
    for attempt in range(_TRACES):
        try:
            rows = _kernel_rows(_between_markers(_traced_calls(fn, args, runs), runs, label),
                                label)
            return sum(r[2] for r in rows), rows
        except RuntimeError:
            if attempt == _TRACES - 1:
                raise


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn, *args, n: int = 20, warmup: int = 2) -> dict[str, float]:
    """Host wall time of ``fn(*args)`` (ms), the card synchronized after
    each call (when the process has started CUDA), so the time covers the
    device's work."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts) * 1e3
    return {
        "min_ms": float(ts.min()),
        "median_ms": float(np.median(ts)),
        "mean_ms": float(ts.mean()),
    }


def cuda_ms(fn, n: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``n`` runs (ms)."""
    _need_card("cuda_ms")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, n: int = 20) -> float:
    """Device time of ``fn`` (ms per call): ``n`` calls queued behind a
    ~100 ms sleep kernel, so the host's launch overhead is hidden and the
    CUDA events time the device running them back to back."""
    _need_card("device_ms")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cold_ms(fn, n: int = 20) -> float:
    """Median time of ``fn`` with the 50 MB L2 flushed before each call (a
    256 MB write between launches)."""
    _need_card("cold_ms")
    scrub = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    pairs = []
    for _ in range(n):
        scrub.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
