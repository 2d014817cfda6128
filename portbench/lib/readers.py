"""What the per-layer readers share: spans by name, percentiles, a
kernel's share of its roofline, the device's idle share."""

from __future__ import annotations

import numpy as np

from portbench.lib import registry


def spans(run, name: str) -> list:
    return [s for s in run.spans if s.name == name]


def roofline_share(run, kernel: str):
    """100 x (the calls' bound) / (the kernel's device time): the device
    operations whose names hold ``kernel``, against ``costs/<kernel>.py``
    over the window's calls. None without a device trace."""
    if run.device is None:
        return None
    t = sum(s for name, s in run.device.op_seconds().items() if kernel in name)
    calls = [c for c in run.window.calls if c["kernel"] == kernel]
    if t <= 0 or not calls:
        return None
    cost = registry.load_module("costs", kernel)
    bound = 0.0
    for c in calls:
        shape = {k: v for k, v in c.items() if k != "kernel"}
        bound += cost.bound_s(peaks=run.peaks, **shape)
    return 100.0 * bound / t


def idle_share(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (run.device.window_s - run.device.busy_s) / run.device.window_s


def percentile(values, q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None
