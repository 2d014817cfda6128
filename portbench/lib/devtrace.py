"""The traced window: ``torch.profiler`` over the host and the card, with
one marker (``portbench.window``) that ties the profiler's clock to the
host's monotonic clock, on which the program's spans are stamped.

`DeviceWindow.read` returns the device's activity inside the window
(kernels, copies, fills): per operation name, the busy time (the union of
all device intervals), and the idle gaps between them, each named by the
innermost span of the driving thread that holds the gap's midpoint.
"""

from __future__ import annotations

import dataclasses
import time

MARK = "portbench.window"


@dataclasses.dataclass
class DeviceRead:
    window_s: float
    busy_s: float
    ops: list  # (name, start, end) on the monotonic clock, inside the window

    def op_seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a)
        return out


def union(intervals):
    """Merged, sorted ``[(a, b)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy, t0: float, t1: float):
    """``[(a, b)]`` of the window not covered by ``busy`` (merged)."""
    gaps, at = [], t0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def name_gaps(gaps, spans, tid: int, top: int = 10):
    """The ``top`` longest gaps as ``[name, seconds]``, each named by the
    innermost span of thread ``tid`` that holds its midpoint ("harness"
    where none does)."""
    own = [s for s in spans if s.tid == tid]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) / 2
        holders = [s for s in own if s.ts <= mid <= s.ts + s.dur]
        name = min(holders, key=lambda s: s.dur).name if holders else "harness"
        named.append([name, b - a])
    return named


class DeviceWindow:
    """Context manager around the measured window. Disabled, it only reads
    the clock; enabled, it profiles the host and the card."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.t0 = self.t1 = 0.0
        self._prof = self._mark = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = record_function(MARK)
            self._mark.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        if self.enabled:
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    def read(self) -> DeviceRead | None:
        """The card's activity in the window, or None when not traced."""
        if not self.enabled:
            return None
        from torch.autograd import DeviceType

        events = self._prof.events()
        marks = [e for e in events if e.name == MARK]
        if not marks:
            raise RuntimeError("the profiler lost the window's marker")
        offset = marks[0].time_range.start / 1e6 - self.t0  # profiler s - monotonic s
        ops = []
        for e in events:
            if e.device_type != DeviceType.CUDA or e.name == MARK:
                continue  # the marker's own device-side annotation spans the window
            a = max(e.time_range.start / 1e6 - offset, self.t0)
            b = min(e.time_range.end / 1e6 - offset, self.t1)
            if b > a:
                ops.append((e.name, a, b))
        busy = sum(b - a for a, b in union((a, b) for _, a, b in ops))
        return DeviceRead(window_s=self.t1 - self.t0, busy_s=busy, ops=ops)
