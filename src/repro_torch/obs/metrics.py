"""Counters, gauges, and fixed-bucket latency histograms.

The numeric half of the observability layer: where `repro_torch.obs.trace` keeps
a *timeline*, this module keeps *aggregates* — monotone counters
(attempts, steals, requests), last-value gauges (queue depths, prefetch
buffer occupancy), and fixed-bucket histograms with quantile readout
(p50/p95/p99 of serve queue-wait, batch size, checkpoint-save duration).
The serve layer's histograms are the live latency/QPS surface the
SLO-driven adaptive microbatch policy (`repro_torch.serve.policy`) consumes;
for that consumer histograms also offer a *windowed-decay* mode (a ring
of fixed-time sub-windows) so the policy reads recent quantiles rather
than the run-lifetime distribution.

Histograms are *fixed-bucket* on purpose: observation cost is a bisect +
one increment under a per-instrument lock (no reservoir, no sort at
readout), memory is constant however many observations arrive, and two
histograms with the same bounds merge by adding counts — the same
mergeable-combiner discipline as the paper's top-k states. Quantiles are
read out by linear interpolation inside the bucket that crosses the
cumulative rank, so p50/p95/p99 are deterministic functions of the counts.

Instruments are created through a :class:`Metrics` registry
(get-or-create by name, thread-safe); `repro_torch.obs` holds the process
default. All mutation is lock-protected per instrument — cross-thread
increments never lose updates (test-pinned) — and locks are held for a
few arithmetic ops only, nowhere near any fold or dispatch critical path.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Metrics", "latency_buckets"]


def latency_buckets(
    lo: float = 1e-5, hi: float = 60.0, factor: float = 2.0
) -> tuple[float, ...]:
    """Geometric bucket bounds for duration-in-seconds histograms.

    Default spans 10µs → 60s at 2× resolution (~23 buckets) — wide enough
    for everything from a checkpoint rename to a straggling shard, cheap
    enough to keep per instrument.
    """
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= factor
    bounds.append(hi)
    return tuple(bounds)


class Counter:
    """A monotone counter. ``inc`` is lock-protected: concurrent workers
    never lose increments (the ``+=`` read-modify-write is not atomic)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def describe(self) -> int:
        return self._value


class Gauge:
    """A last-value-wins instrument (queue depth, buffer occupancy).

    Tracks the max ever set alongside the current value — for bounded
    queues, "how full did it get" is the number that matters after the
    fact.
    """

    __slots__ = ("name", "_lock", "_value", "_max")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            if value > self._max:
                self._max = value

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max

    def describe(self) -> dict:
        return {"value": self._value, "max": self._max}


class _Window:
    """One sub-window of a windowed histogram: a full bucket-count vector
    plus its own n/sum/min/max so aggregates merge exactly."""

    __slots__ = ("counts", "n", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.clear()

    def clear(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.n = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram:
    """Fixed-bucket histogram with interpolated quantile readout.

    ``bounds`` are ascending bucket upper edges; observations above the
    last edge land in a +inf overflow bucket. ``observe`` is a bisect +
    increment under the instrument lock; ``quantile`` interpolates
    linearly within the crossing bucket (clamped to the observed min/max,
    so a one-element histogram reads back that element exactly).

    **Windowed-decay mode** (``window_s`` set): instead of one cumulative
    count vector, the histogram keeps a ring of ``n_windows`` fixed-time
    sub-windows spanning ``window_s`` seconds in total. Observations land
    in the current sub-window; as the injected ``clock`` advances past a
    sub-window boundary the ring rotates, dropping the oldest sub-window —
    so every readout (count/quantile/summary) reflects only roughly the
    last ``window_s`` seconds. This is the surface the serve layer's
    adaptive policy reads: *recent* p99, not the run-lifetime distribution.
    The default (``window_s=None``) stays cumulative. A clock that reads
    earlier than the current sub-window start (injected test clocks may be
    stamped backwards) never rotates — observations just land in the
    current sub-window.
    """

    __slots__ = (
        "name", "bounds", "_lock", "_counts", "_n", "_sum", "_min", "_max",
        "window_s", "_clock", "_wins", "_win_idx", "_win_start", "_sub",
    )

    def __init__(
        self,
        name: str,
        bounds: Sequence[float] | None = None,
        *,
        window_s: float | None = None,
        n_windows: int = 8,
        clock: Callable[[], float] | None = None,
    ):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else latency_buckets()
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be ascending+unique: {bounds}")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self.window_s = window_s
        if window_s is not None:
            if window_s <= 0:
                raise ValueError(f"window_s must be positive, got {window_s}")
            if not isinstance(n_windows, int) or n_windows < 1:
                raise ValueError(f"n_windows must be a positive int, got {n_windows}")
            self._clock = clock if clock is not None else time.monotonic
            self._sub = window_s / n_windows
            self._wins = [_Window(len(self.bounds) + 1) for _ in range(n_windows)]
            self._win_idx = 0
            self._win_start = self._clock()
        else:
            self._clock = None
            self._wins = None

    def _rotate(self) -> None:
        """Advance the ring to the clock's current sub-window (lock held).
        A gap longer than the whole window clears every sub-window."""
        now = self._clock()
        if now < self._win_start + self._sub:
            return  # still inside the current sub-window (or clock rewound)
        k = int((now - self._win_start) // self._sub)
        if k >= len(self._wins):
            for w in self._wins:
                w.clear()
        else:
            for _ in range(k):
                self._win_idx = (self._win_idx + 1) % len(self._wins)
                self._wins[self._win_idx].clear()
        self._win_start += k * self._sub

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            if self._wins is not None:
                self._rotate()
                w = self._wins[self._win_idx]
                w.counts[i] += 1
                w.n += 1
                w.sum += value
                if value < w.min:
                    w.min = value
                if value > w.max:
                    w.max = value
                return
            self._counts[i] += 1
            self._n += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def _agg(self) -> tuple[list[int], int, float, float, float]:
        """(counts, n, sum, min, max) over the live data (lock held):
        the cumulative fields, or the merged ring in windowed mode."""
        if self._wins is None:
            return self._counts, self._n, self._sum, self._min, self._max
        self._rotate()
        counts = [0] * (len(self.bounds) + 1)
        n, s = 0, 0.0
        mn, mx = float("inf"), float("-inf")
        for w in self._wins:
            if not w.n:
                continue
            for i, c in enumerate(w.counts):
                counts[i] += c
            n += w.n
            s += w.sum
            mn = min(mn, w.min)
            mx = max(mx, w.max)
        return counts, n, s, mn, mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._agg()[1]

    @property
    def sum(self) -> float:
        with self._lock:
            return self._agg()[2]

    @property
    def mean(self) -> float:
        with self._lock:
            _, n, s, _, _ = self._agg()
        return s / n if n else 0.0

    def _quantile_from(
        self, counts: Sequence[int], n: int, mn: float, mx: float, q: float
    ) -> float:
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(mn, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else mx
                frac = (rank - cum) / c
                val = lo + (hi - lo) * max(0.0, min(1.0, frac))
                # never report outside the observed range
                return max(mn, min(mx, val))
            cum += c
        return mx  # pragma: no cover — rank <= n always crosses

    def quantile(self, q: float) -> float:
        """Interpolated quantile in [0, 1]; 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            counts, n, _, mn, mx = self._agg()
            if n == 0:
                return 0.0
            return self._quantile_from(counts, n, mn, mx, q)

    def summary(self) -> dict:
        """The rollup exported into reports: count/mean/min/max + p50/95/99."""
        with self._lock:
            counts, n, s, mn, mx = self._agg()
            if n == 0:
                out = {"count": 0}
                if self.window_s is not None:
                    out["window_s"] = self.window_s
                return out
            out = {
                "count": n,
                "mean": s / n,
                "min": mn,
                "max": mx,
                "p50": self._quantile_from(counts, n, mn, mx, 0.50),
                "p95": self._quantile_from(counts, n, mn, mx, 0.95),
                "p99": self._quantile_from(counts, n, mn, mx, 0.99),
            }
        if self.window_s is not None:
            out["window_s"] = self.window_s
        return out

    describe = summary


class Metrics:
    """Get-or-create registry of named instruments (one per process area).

    A name is permanently bound to its first-created instrument kind;
    asking for the same name as a different kind is a bug and raises.
    ``summary()`` renders everything into plain dicts for ``report.json``
    (the ``job.obs.metrics`` block) and the JSONL exporter.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, not a {kind.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(
        self,
        name: str,
        bounds: Sequence[float] | None = None,
        *,
        window_s: float | None = None,
        n_windows: int = 8,
        clock: Callable[[], float] | None = None,
    ) -> Histogram:
        """Get-or-create; creation kwargs (bounds, windowing, clock) apply
        on first creation only — later lookups return the existing
        instrument unchanged (same contract as ``bounds`` always had)."""
        return self._get(
            name,
            Histogram,
            lambda: Histogram(
                name, bounds, window_s=window_s, n_windows=n_windows, clock=clock
            ),
        )

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def summary(self) -> dict:
        """Plain-dict rollup of every instrument, grouped by kind."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out["counters"][name] = inst.describe()
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.describe()
            else:
                out["histograms"][name] = inst.summary()
        return out
