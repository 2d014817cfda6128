"""What the per-layer readers share: spans by name, percentiles, a
kernel's share of its roofline, a model step's share of the card's peak
(``mfu``), the device's idle share, in all or inside spans of one name."""

from __future__ import annotations

import numpy as np

from portbench.lib import registry
from portbench.lib import spans as sp

# a configuration's ``dtype`` -> the dense peak of ``peaks.json`` its matmuls run at
DTYPE_PEAK = {"bf16": "bf16_tensor_flops_per_s", "tf32": "tf32_tensor_flops_per_s",
              "fp32": "fp32_flops_per_s"}


def spans(run, name: str) -> list:
    return [s for s in run.spans if s.name == name]


def _shapes(run, kernel: str) -> list:
    """The shapes of the window's calls of ``kernel``."""
    return [{k: v for k, v in c.items() if k != "kernel"}
            for c in run.window.calls if c["kernel"] == kernel]


def roofline_share(run, kernel: str):
    """100 x (the calls' bound) / (the kernel's device time): the device
    operations whose names hold ``kernel``, against ``costs/<kernel>.py``
    over the window's calls. None without a device trace."""
    if run.device is None:
        return None
    t = sum(s for name, s in run.device.op_seconds().items() if kernel in name)
    shapes = _shapes(run, kernel)
    if t <= 0 or not shapes:
        return None
    cost = registry.load_module("costs", kernel, run.root)
    return 100.0 * sum(cost.bound_s(peaks=run.peaks, **shape) for shape in shapes) / t


def mfu_share(run, model: str, span: str):
    """100 x (the window's steps' operations) / (the steps' time x the
    card's peak): ``costs/<model>.py``'s ``flops`` summed over the window's
    calls whose ``kernel`` is ``model`` (one a step), over the summed
    duration of the program's spans named ``span`` times the dense peak of
    the configuration's ``dtype`` (`DTYPE_PEAK`). None without a device
    trace, spans or calls."""
    if run.device is None:
        return None
    t = sum(s.dur for s in spans(run, span))
    shapes = _shapes(run, model)
    if t <= 0 or not shapes:
        return None
    cost = registry.load_module("costs", model, run.root)
    flops = sum(cost.flops(**shape) for shape in shapes)
    return 100.0 * flops / (t * run.peaks[DTYPE_PEAK[run.config["dtype"]]])


def idle_share(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (run.device.window_s - run.device.busy_s) / run.device.window_s


def percentile(values, q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None


def span_median_ms(run, name: str):
    """Median ms of the program's spans named ``name``."""
    return percentile([s.dur * 1e3 for s in spans(run, name)], 50)


def idle_in_spans(run, name: str):
    """Share of the traced window, in %, inside a span named ``name`` with
    no operation on the card. None without a device trace or such spans."""
    d = spans(run, name)
    if run.device is None or run.device.window_s <= 0 or not d:
        return None
    return 100.0 * sp.uncovered_s(d, sp.busy(run)) / run.device.window_s
