"""Trace/metrics exporters: Chrome ``trace_event`` JSON, JSONL, text tree.

Three renderings of one span buffer, for three audiences:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` — the Chrome
  ``trace_event`` "JSON object format": open the file in
  ``chrome://tracing`` or https://ui.perfetto.dev and every shard worker,
  the prefetch producer, the checkpoint writer, and the scheduler appear
  as labelled thread lanes; spans nest by time containment, fault
  injections and scheduler decisions show as instant markers. Timestamps
  are re-based to the earliest event and converted to microseconds (the
  format's unit). The metrics rollup rides along under ``otherData`` so a
  trace file is self-contained.
* :func:`write_jsonl` — one event per line, machine-grep-able: the
  scheduler event log (`sched.*` instants), fault firings (`fault.*`),
  and every span with its raw monotonic timestamps. The format CI
  artifacts and ad-hoc ``jq`` analysis consume.
* :func:`summary_tree` — a plain-text time-per-phase rollup, grouped by
  the ``shard`` attribute then span name (count, total, mean): the
  at-a-glance "where did this job spend its time" answer, printed by the
  experiment CLI after a traced run.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import SpanEvent, Tracer

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "summary_tree",
]

_PID = 0  # single-process; multi-host traces would key pid by host rank


def _events_of(source: Tracer | Iterable[SpanEvent]) -> list[SpanEvent]:
    return source.events() if isinstance(source, Tracer) else list(source)


def to_chrome_trace(
    source: Tracer | Iterable[SpanEvent],
    *,
    metrics: Metrics | None = None,
) -> dict:
    """Render events as a Chrome ``trace_event`` JSON object (not yet a file).

    Complete spans become ``ph="X"`` events, instants ``ph="i"`` with
    thread scope; per-thread ``thread_name`` metadata events label the
    lanes. All timestamps shift so the trace starts at t=0 (viewers dislike
    raw monotonic offsets) and scale to integer-friendly microseconds.
    """
    events = _events_of(source)
    t0 = min((e.ts for e in events), default=0.0)
    out = []
    seen_threads: dict[int, str] = {}
    for e in events:
        if e.tid not in seen_threads and e.tname:
            seen_threads[e.tid] = e.tname
        rec = {
            "name": e.name,
            "cat": e.cat or "default",
            "ph": e.ph,
            "ts": (e.ts - t0) * 1e6,
            "pid": _PID,
            "tid": e.tid,
            "args": dict(e.attrs),
        }
        if e.ph == "X":
            rec["dur"] = e.dur * 1e6
        else:
            rec["s"] = "t"  # instant scoped to its thread
        out.append(rec)
    for tid, tname in sorted(seen_threads.items()):
        out.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    payload: dict = {"traceEvents": out, "displayTimeUnit": "ms"}
    if metrics is not None:
        payload["otherData"] = {"metrics": metrics.summary()}
    return payload


def write_chrome_trace(
    path: str,
    source: Tracer | Iterable[SpanEvent],
    *,
    metrics: Metrics | None = None,
) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(source, metrics=metrics), f)
        f.write("\n")
    return path


def write_jsonl(path: str, source: Tracer | Iterable[SpanEvent]) -> str:
    """One JSON object per event, raw tracer-clock timestamps preserved."""
    with open(path, "w") as f:
        for e in _events_of(source):
            json.dump(
                {
                    "name": e.name,
                    "cat": e.cat,
                    "ph": e.ph,
                    "ts": e.ts,
                    "dur": e.dur,
                    "tid": e.tid,
                    "thread": e.tname,
                    "attrs": dict(e.attrs),
                },
                f,
            )
            f.write("\n")
    return path


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds * 1e6:.0f}µs"


def phase_rollup(source: Tracer | Iterable[SpanEvent]) -> dict:
    """``{shard_label: {span_name: {count, total_s, mean_s}}}`` rollup.

    Spans carrying a ``shard`` attribute group under ``shard <i>``;
    everything else (serve dispatch, scheduler internals, experiment
    phases) lands under ``(global)``. This is the dict embedded in
    ``report.json`` under ``job.obs.phases``.
    """
    groups: dict[str, dict[str, list[float]]] = {}
    for e in _events_of(source):
        if e.ph != "X":
            continue
        shard = e.attrs.get("shard")
        label = "(global)" if shard is None else f"shard {shard}"
        groups.setdefault(label, {}).setdefault(e.name, []).append(e.dur)
    out: dict[str, dict] = {}
    for label in sorted(groups, key=lambda s: (s != "(global)", s)):
        out[label] = {
            name: {
                "count": len(durs),
                "total_s": sum(durs),
                "mean_s": sum(durs) / len(durs),
            }
            for name, durs in sorted(groups[label].items())
        }
    return out


def summary_tree(
    source: Tracer | Iterable[SpanEvent],
    *,
    metrics: Metrics | None = None,
) -> str:
    """Human-readable time-per-phase tree (per shard, then per span name)."""
    events = _events_of(source)
    spans = [e for e in events if e.ph == "X"]
    instants = [e for e in events if e.ph == "i"]
    if not events:
        return "trace: no events recorded"
    t_lo = min(e.ts for e in events)
    t_hi = max(e.ts + e.dur for e in events)
    lines = [
        f"trace: {len(spans)} spans, {len(instants)} instants over "
        f"{_fmt_s(t_hi - t_lo)} wall"
    ]
    rollup = phase_rollup(spans)
    for g, (label, names) in enumerate(rollup.items()):
        last_group = g == len(rollup) - 1
        lines.append(f"{'└─' if last_group else '├─'} {label}")
        stem = "   " if last_group else "│  "
        items = list(names.items())
        for i, (name, agg) in enumerate(items):
            tee = "└─" if i == len(items) - 1 else "├─"
            lines.append(
                f"{stem}{tee} {name:<28} ×{agg['count']:<4} "
                f"{_fmt_s(agg['total_s']):>9} total  "
                f"{_fmt_s(agg['mean_s']):>9} mean"
            )
    if instants:
        by_name: dict[str, int] = {}
        for e in instants:
            by_name[e.name] = by_name.get(e.name, 0) + 1
        marks = ", ".join(f"{n}×{c}" for n, c in sorted(by_name.items()))
        lines.append(f"instants: {marks}")
    if metrics is not None:
        hists = metrics.summary()["histograms"]
        for name, s in hists.items():
            if s.get("count"):
                lines.append(
                    f"hist {name}: n={s['count']} p50={s['p50']:.4g} "
                    f"p95={s['p95']:.4g} p99={s['p99']:.4g}"
                )
    return "\n".join(lines)
