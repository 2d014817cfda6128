"""Open-loop sustained-load generation for the retrieval service.

Closed-loop benchmarks (issue a batch, wait, issue the next — the C1
sweep) can never see the serving knee: the client self-throttles, so the
queue never grows. An **open-loop** generator issues requests at their
scheduled arrival times *regardless of completions* — past the capacity
knee the backlog grows without bound and tail latency explodes, which is
exactly the regime the admission controller and the adaptive policy
exist for.

The generator is a **discrete-event simulation on a virtual clock**, not
a wall-clock threadpool: arrivals are stamped at their nominal schedule
times, and the server's clock advances by the *real, measured* scan time
of every dispatched block (:class:`MeteredSession` wraps the real session
and meters each ``search`` with ``perf_counter``). Real kernel latencies,
deterministic interleaving — the same seed replays the same run, and the
latency of every request is exact (arrival stamp → metered completion),
not quantized by poll-loop sleeps.

Mechanically the loop interleaves two event sources in time order:

* the **arrival schedule** (:func:`poisson_schedule` /
  :func:`burst_schedule`, seeded) — the clock is rewound to the nominal
  arrival time to stamp the submit (the windowed obs histograms tolerate
  rewinds by design), then restored to server time;
* the service's **next deadline** — a block whose deadline expires while
  the server is busy dispatches as soon as the server frees up, exactly
  like a real single-threaded event loop.

Dispatches go through ``service.poll(limit=1)`` so every block's
completion time is read off the virtual clock individually.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.serve.admission import Admitted, Blocked, Shed
from repro_torch.serve.service import RetrievalService, SearchResult


def poisson_schedule(
    qps: float, n: int, *, seed: int = 0, start: float = 0.0
) -> np.ndarray:
    """``n`` arrival times of a Poisson process at ``qps`` (seeded)."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / qps, size=n))


def burst_schedule(
    qps: float,
    n: int,
    *,
    seed: int = 0,
    start: float = 0.0,
    burst_factor: float = 4.0,
    duty: float = 0.25,
    period_s: float = 1.0,
) -> np.ndarray:
    """Bursty arrivals: a Poisson process whose rate alternates each
    ``period_s`` between ``qps * burst_factor`` (for the ``duty`` fraction
    of the period) and a floor rate — same seed, same schedule. The *mean*
    rate is approximately ``qps`` when ``burst_factor * duty <= 1``."""
    if qps <= 0:
        raise ValueError("qps must be positive")
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0,1): {duty}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1: {burst_factor}")
    rng = np.random.default_rng(seed)
    high = qps * burst_factor
    # the off-phase rate that keeps the long-run mean at qps, floored so
    # the process never stalls entirely
    low = max(qps * (1.0 - burst_factor * duty) / (1.0 - duty), qps * 0.05)
    out = np.empty(n)
    t = start
    for i in range(n):
        rate = high if (t % period_s) < duty * period_s else low
        t += rng.exponential(1.0 / rate)
        out[i] = t
    return out


class VirtualClock:
    """The injectable clock of a simulated serving run. ``advance`` moves
    forward (metered scan time); ``rewind`` is permitted only for stamping
    an arrival that nominally happened while the server was busy."""

    __slots__ = ("t",)

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance by {dt}")
        self.t += dt

    def set(self, t: float) -> None:
        self.t = float(t)


class MeteredSession:
    """Wrap a real session so every ``search`` advances the virtual clock
    by its real, host-synchronized wall time. Everything else (pad_value,
    kind, k, n_docs, ...) delegates to the wrapped session."""

    def __init__(self, session, clock: VirtualClock, *, scale: float = 1.0):
        if scale <= 0:
            raise ValueError("scale must be positive")
        self._session = session
        self._clock = clock
        self._scale = scale

    def __getattr__(self, name):
        return getattr(self._session, name)

    def search(self, queries):
        t0 = time.perf_counter()
        state = self._session.search(queries)
        # force the device work to completion so the metered time is the
        # real scan latency, not the async dispatch cost
        np.asarray(state.scores)
        self._clock.advance((time.perf_counter() - t0) * self._scale)
        return state


@dataclasses.dataclass
class OpenLoopResult:
    """One sustained-load run: exact per-request outcomes on the virtual
    timeline. ``rid_of[i]`` maps offered-request index → rid (admitted
    requests only); sheds carry the typed admission outcome."""

    arrivals: np.ndarray  # [n_offered] nominal arrival times
    rid_of: dict[int, int]
    results: dict[int, SearchResult]
    completions: dict[int, float]  # rid -> virtual completion time
    shed: list[tuple[int, Shed | Blocked]]
    duration_s: float

    @property
    def n_offered(self) -> int:
        return len(self.arrivals)

    @property
    def n_completed(self) -> int:
        return len(self.completions)

    @property
    def shed_rate(self) -> float:
        return len(self.shed) / max(self.n_offered, 1)

    @property
    def offered_qps(self) -> float:
        span = self.arrivals[-1] - self.arrivals[0] if len(self.arrivals) > 1 else 0.0
        return (self.n_offered - 1) / span if span > 0 else float("inf")

    def latencies(self) -> np.ndarray:
        """Completed requests' admission→reply latency, seconds, exact."""
        arrival_of_rid = {
            rid: self.arrivals[i] for i, rid in self.rid_of.items()
        }
        return np.array(
            [t - arrival_of_rid[rid] for rid, t in sorted(self.completions.items())]
        )

    def latency_quantiles(self) -> dict[str, float]:
        lat = self.latencies()
        if lat.size == 0:
            return {"p50_ms": float("nan"), "p95_ms": float("nan"), "p99_ms": float("nan")}
        return {
            "p50_ms": float(np.quantile(lat, 0.50) * 1e3),
            "p95_ms": float(np.quantile(lat, 0.95) * 1e3),
            "p99_ms": float(np.quantile(lat, 0.99) * 1e3),
        }


def run_open_loop(
    service: RetrievalService,
    clock: VirtualClock,
    schedule: Sequence[float],
    queries: np.ndarray,
    *,
    kind: str | None = None,
    lane_of: Callable[[int], str] | None = None,
    tenant_of: Callable[[int], str] | None = None,
) -> OpenLoopResult:
    """Drive ``service`` (built on ``clock`` and metered sessions) through
    the arrival ``schedule``: request ``i`` submits ``queries[i]`` at
    ``schedule[i]``. Returns exact per-request outcomes.

    The event loop processes, in virtual-time order, whichever comes first
    of the next arrival and the server's next possible dispatch (a trigger
    that has fired, or the next microbatch deadline — either way no
    earlier than the time the server frees up). Arrivals that nominally
    land *during* a scan are enqueued before the next block closes, so
    queue depth at admission time is the real backlog — a trigger that
    expires while the server is busy fires the moment it frees up, and one
    block dispatches per event so every completion lands at its own
    metered clock reading.
    """
    schedule = np.asarray(schedule, dtype=float)
    n = len(schedule)
    if len(queries) < n:
        raise ValueError(f"{n} arrivals but only {len(queries)} queries")
    if n and np.any(np.diff(schedule) < 0):
        raise ValueError("schedule must be sorted")

    rid_of: dict[int, int] = {}
    results: dict[int, SearchResult] = {}
    completions: dict[int, float] = {}
    shed: list[tuple[int, Shed | Blocked]] = []

    start_t = clock.t
    server_t = clock.t
    i = 0
    while i < n or service.pending() > 0:
        next_arrival = schedule[i] if i < n else math.inf
        ra = service.ready_at(server_t)
        dispatch_at = math.inf if ra is None else max(server_t, ra)
        if math.isinf(next_arrival) and math.isinf(dispatch_at):
            # pending work but no trigger will ever fire (infinite
            # max_delay): force-flush at server time
            clock.set(server_t)
            for rid, res in service.drain().items():
                results[rid] = res
                completions[rid] = clock.t
            break
        if next_arrival <= dispatch_at:
            # stamp the submit at the *nominal* arrival time, even when the
            # server is currently busy past it (that is what open-loop
            # means); then restore server time
            clock.set(next_arrival)
            outcome = service.try_submit(
                queries[i],
                kind,
                tenant=tenant_of(i) if tenant_of is not None else "default",
                lane=lane_of(i) if lane_of is not None else "interactive",
            )
            if isinstance(outcome, Admitted):
                rid_of[i] = outcome.rid
            else:
                shed.append((i, outcome))
            i += 1
            clock.set(server_t)
            continue
        # dispatch exactly one block at the trigger time (or as soon as the
        # server is free); the metered scan advances the clock, and any
        # arrivals that nominally landed during it are enqueued (above,
        # with their true stamps) before the next block closes
        clock.set(dispatch_at)
        ready = service.poll(limit=1)
        done_t = clock.t
        for rid, res in ready.items():
            results[rid] = res
            completions[rid] = done_t
        server_t = clock.t

    return OpenLoopResult(
        arrivals=schedule,
        rid_of=rid_of,
        results=results,
        completions=completions,
        shed=shed,
        duration_s=clock.t - start_t,
    )
