"""Thread-safe span tracing with a bounded in-memory buffer.

The cluster job's whole argument is operational — "sequential scanning is
viable" means knowing where an 11-hour job spends its time — so every hot
layer (scan job, scheduler, prefetch pipeline, checkpoint writer, serve
dispatch) emits *spans*: named intervals on the shared monotonic clock,
tagged with the emitting thread, a category, and ``key=value`` attributes.
Overlap and nesting need no parent bookkeeping: spans carry wall-clock
extent + thread id, which is exactly the Chrome ``trace_event`` model
(`repro_torch.obs.export` renders the buffer for ``chrome://tracing``/Perfetto —
same-thread spans nest by time containment, cross-thread work lines up on
the common timebase).

Design constraints, both load-bearing:

* **disabled ⇒ near-zero cost** — :meth:`Tracer.span` is guard-checked:
  one attribute read, then a shared no-op singleton. No locks, no
  allocation, no clock read. Instrumentation can therefore live
  permanently in per-segment loops and scheduler internals.
* **enabled ⇒ lock-free fast path** — events land in a
  ``collections.deque(maxlen=...)`` whose ``append`` is atomic under the
  GIL, so concurrent shard workers, the prefetch producer, and the
  checkpoint writer thread all record without serializing on a tracer
  lock. The bound makes the buffer safe to leave on for long jobs: old
  events fall off the front.

Tracing observes; it never participates. No instrumented code path reads
tracer state to make a decision, so a traced run executes the exact
instruction stream of an untraced one — the chaos suite pins run-file
byte-identity with tracing ON.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Mapping

__all__ = ["SpanEvent", "Tracer", "NULL_SPAN"]


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span (``ph="X"``) or instant marker (``ph="i"``).

    Timestamps are seconds on the tracer's clock (monotonic by default);
    ``dur`` is 0.0 for instants. ``attrs`` is the span's final attribute
    mapping — an exception inside a ``with tracer.span(...)`` block lands
    here as ``error=<type name>`` before propagating.
    """

    name: str
    cat: str
    ph: str  # "X" complete span | "i" instant
    ts: float  # start, seconds (tracer clock)
    dur: float  # seconds ("X" only)
    tid: int  # emitting thread id
    attrs: Mapping[str, Any]
    tname: str = ""  # emitting thread's name (trace viewer lane label)


class _NullSpan:
    """The shared disabled-tracer span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: context manager that records itself on exit.

    The span is recorded even when the body raises (with the exception
    type under ``attrs["error"]``) and the exception propagates — so a
    fold that dies mid-segment still leaves its span in the timeline,
    and enclosing spans close in LIFO order with correct extents.
    """

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._t0 = 0.0

    def set(self, **attrs: Any) -> "_Span":
        """Attach/overwrite attributes before the span closes."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        t1 = self._tracer._clock()
        thread = threading.current_thread()
        self._tracer._events.append(
            SpanEvent(
                name=self.name,
                cat=self.cat,
                ph="X",
                ts=self._t0,
                dur=t1 - self._t0,
                tid=thread.ident or 0,
                attrs=self.attrs,
                tname=thread.name,
            )
        )
        return False  # never swallow


class Tracer:
    """Span/instant recorder over a bounded thread-safe buffer.

    ``enabled=False`` (the module default in `repro_torch.obs`) short-circuits
    every entry point before any clock read or allocation. ``max_events``
    bounds memory for long-lived jobs — the deque drops the *oldest*
    events, so the tail of a run (usually where the trouble is) survives.
    ``clock`` is injectable for deterministic trigger tests; production
    uses the monotonic clock, immune to wall-clock steps.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        max_events: int = 200_000,
        clock=time.monotonic,
    ):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.enabled = enabled
        self.max_events = max_events
        self._clock = clock
        self._events: collections.deque[SpanEvent] = collections.deque(
            maxlen=max_events
        )
        # stable small ints for thread ids at export time (get_ident values
        # are reused by the OS; we only need a per-trace label)
        self._t_origin = clock()

    # -- recording (the fast paths) -----------------------------------------

    def span(self, name: str, cat: str = "", **attrs: Any):
        """Context manager timing its body; records on exit (even on error)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, attrs)

    def instant(self, name: str, cat: str = "", **attrs: Any) -> None:
        """A zero-duration marker (fault fired, retry enqueued, ...)."""
        if not self.enabled:
            return
        thread = threading.current_thread()
        self._events.append(
            SpanEvent(
                name=name,
                cat=cat,
                ph="i",
                ts=self._clock(),
                dur=0.0,
                tid=thread.ident or 0,
                attrs=attrs,
                tname=thread.name,
            )
        )

    def record(
        self,
        name: str,
        t0: float,
        t1: float,
        cat: str = "",
        *,
        tid: int | None = None,
        **attrs: Any,
    ) -> None:
        """Record a span with an explicit ``[t0, t1]`` window on the tracer
        clock — for intervals whose start predates the recording site (a
        serve request's enqueue→reply life, measured at reply time)."""
        if not self.enabled:
            return
        thread = threading.current_thread()
        self._events.append(
            SpanEvent(
                name=name,
                cat=cat,
                ph="X",
                ts=t0,
                dur=max(0.0, t1 - t0),
                tid=(thread.ident or 0) if tid is None else tid,
                attrs=attrs,
                tname=thread.name if tid is None else "",
            )
        )

    # -- readout -------------------------------------------------------------

    def events(self) -> list[SpanEvent]:
        """Snapshot of the buffer, oldest first (safe during recording)."""
        return list(self._events)

    def spans(self, name: str | None = None, cat: str | None = None) -> list[SpanEvent]:
        """Complete spans, optionally filtered by exact name and/or category."""
        return [
            e
            for e in self._events
            if e.ph == "X"
            and (name is None or e.name == name)
            and (cat is None or e.cat == cat)
        ]

    def instants(self, name: str | None = None) -> list[SpanEvent]:
        return [
            e for e in self._events if e.ph == "i" and (name is None or e.name == name)
        ]

    def clear(self) -> None:
        self._events.clear()

    def __len__(self) -> int:
        return len(self._events)
