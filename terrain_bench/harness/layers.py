"""What the per-layer readers share: medians over the traced frames, and a
kernel's share of its roofline."""

from __future__ import annotations

import re
import statistics


def median(values):
    return float(statistics.median(values)) if values else None


def kernels(records: list) -> list:
    """The kernel launches among a phase's device records (not the copies
    and fills, which the profiler names ``Memcpy ...`` and ``Memset ...``)."""
    return [r for r in records if not r[2].startswith(("Memcpy", "Memset"))]


def kernel_us(records: list, pattern: str) -> float:
    """Summed device microseconds of the records whose name matches."""
    rx = re.compile(pattern)
    return sum(e - s for s, e, name in records if rx.search(name))


def roofline_pct(t: dict, pattern: str, least_s) -> "float | None":
    """The median over the traced frames of ``least_s(live tiles)`` over the
    device time of the update's kernels matching ``pattern``, in percent;
    None where no such kernel ran."""
    shares = []
    for f in t["frames"]:
        us = kernel_us(f["update"], pattern)
        if us > 0:
            shares.append(100.0 * least_s(f["live"]) / (us / 1e6))
    return median(shares)
