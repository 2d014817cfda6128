"""The program's spans against the card's activity: how much of the time
inside spans of one name the card was busy, and the spans of each block.

Spans and device intervals are on one clock: `devtrace.DeviceWindow` maps
the profiler's onto the monotonic clock the program stamps its spans on.
"""

from __future__ import annotations

from portbench.lib import devtrace


def intervals(spans) -> list:
    """``[(start, end)]`` of the spans."""
    return [(s.ts, s.ts + s.dur) for s in spans]


def busy(run) -> list:
    """The union of the card's operations in the window, merged and sorted."""
    return [(a, b) for a, b in devtrace.union((a, b) for _, a, b in run.device.ops)]


def covered_s(spans, merged) -> float:
    """Seconds of the union of ``spans``' intervals that ``merged`` (merged,
    sorted intervals, as `devtrace.union` gives them) covers."""
    total, j = 0.0, 0
    for a, b in devtrace.union(intervals(spans)):
        while j < len(merged) and merged[j][1] <= a:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < b:
            total += min(merged[k][1], b) - max(merged[k][0], a)
            k += 1
    return total


def uncovered_s(spans, merged) -> float:
    """Seconds of the union of ``spans``' intervals that ``merged`` leaves
    uncovered: time counted once, however the spans overlap."""
    inside = sum(b - a for a, b in devtrace.union(intervals(spans)))
    return inside - covered_s(spans, merged)


def by_block(spans) -> dict:
    """The spans that carry a ``block`` attribute, by block."""
    return {s.attrs["block"]: s for s in spans if "block" in s.attrs}
