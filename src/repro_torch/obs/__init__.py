"""Cluster-wide tracing & metrics — the observability layer.

MIREX's viability argument is operational, so the framework's hot layers
(scan jobs, the shard scheduler, the prefetch pipeline, the checkpoint
writer, serve dispatch) are permanently instrumented against one
process-wide pair of instruments:

* :func:`tracer` — the active :class:`~repro_torch.obs.trace.Tracer` (span
  timelines + instant markers; **disabled by default** and near-zero-cost
  while disabled, so instrumentation lives inside per-segment loops);
* :func:`metrics` — the active :class:`~repro_torch.obs.metrics.Metrics`
  registry (counters / gauges / p50-p95-p99 histograms; always on — an
  observation is a couple of arithmetic ops under a short lock).

Enable tracing by installing an enabled tracer for a scope::

    from repro_torch import obs
    with obs.session() as (tr, met):          # fresh enabled pair
        job = cluster.run_sharded_scan_job(...)
    obs.export.write_chrome_trace("trace.json", tr, metrics=met)

or pass ``--trace-out trace.json`` to ``repro_torch.launch.experiment``, which
wraps the whole lifecycle and writes the Chrome trace, the JSONL event
log, and the ``report.json`` ``job.obs`` rollup.

The globals are plain module state, not contextvars, on purpose: the
instrumented layers hand work to long-lived helper threads (scheduler
workers, the checkpoint writer, the prefetch producer) that must record
into the *same* buffer as the thread that installed it — which contextvar
propagation across threads would silently break.

Tracing observes and never decides: no instrumented code path branches on
tracer state (beyond skipping the recording itself), so traced runs are
byte-identical to untraced ones — asserted by the chaos suite, which runs
with tracing ON.
"""

from __future__ import annotations

import contextlib
import platform
import sys

from repro_torch.obs import export
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Metrics, latency_buckets
from repro_torch.obs.trace import NULL_SPAN, SpanEvent, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Metrics",
    "NULL_SPAN",
    "SpanEvent",
    "Tracer",
    "export",
    "install",
    "latency_buckets",
    "metrics",
    "gpu_name_and_power_limit",
    "provenance",
    "session",
    "tracer",
]

# the process defaults: tracing off (guard-checked no-op), metrics on
_TRACER = Tracer(enabled=False)
_METRICS = Metrics()


def tracer() -> Tracer:
    """The active tracer (instrumented layers call this per operation, so
    an `install` mid-process takes effect everywhere immediately)."""
    return _TRACER


def metrics() -> Metrics:
    """The active metrics registry."""
    return _METRICS


def install(
    tracer: Tracer | None = None, metrics: Metrics | None = None
) -> tuple[Tracer, Metrics]:
    """Swap the active instruments; returns the previous pair (for restore).

    ``None`` leaves that instrument unchanged. Prefer :func:`session` in
    tests — it restores on exit.
    """
    global _TRACER, _METRICS
    prev = (_TRACER, _METRICS)
    if tracer is not None:
        _TRACER = tracer
    if metrics is not None:
        _METRICS = metrics
    return prev


@contextlib.contextmanager
def session(tracer: Tracer | None = None, metrics: Metrics | None = None):
    """Scoped observability: install a (default: fresh, enabled) tracer and
    a fresh metrics registry, restore the previous pair on exit. Yields
    ``(tracer, metrics)``."""
    tr = Tracer() if tracer is None else tracer
    met = Metrics() if metrics is None else metrics
    prev = install(tr, met)
    try:
        yield tr, met
    finally:
        install(*prev)


def provenance() -> dict:
    """Where a measurement was taken: host, platform, device, versions.

    Reports torch and its CUDA build, and for a CUDA device also the card's
    name and power limit as ``nvidia-smi`` reads them (a card may be capped
    below its maximum, and then runs slower under load).
    """
    import torch  # deferred: obs must import without initializing CUDA

    out = {
        "host": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "n_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }
    if torch.cuda.is_available():
        out["device_name"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = gpu_name_and_power_limit()
    return out


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
