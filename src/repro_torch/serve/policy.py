"""SLO-driven adaptive microbatch control: the serving-layer closed loop.

The microbatch triggers are a latency/amortization tradeoff: a bigger
block is cheaper per query (claim C1) but waits longer to fill; a longer
deadline raises occupancy but pays queue wait. The static knobs picked
offline are only right for one load level — this module re-picks them
*online*, from the live request-latency distribution the service already
records into its injected :class:`~repro_torch.obs.metrics.Metrics` registry.

The control loop, once per ``interval_s`` (driven from ``service.poll``):

1. **read** — recent p99 of admission→reply request latency from the
   *windowed* histogram (``serve.recent.request_s``; a ring of fixed-time
   sub-windows, so stale samples age out — the policy reacts to the last
   ``window_s`` seconds, not the run's lifetime);
2. **decide** — compare against the SLO with a hysteresis band: above
   ``slo · (1+band)`` tighten, below ``slo · (1-band)`` relax, inside the
   band do nothing (the band is what keeps a marginal load level from
   flapping the knobs);
3. **act** — one bounded step on the effective triggers, written through
   the batchers' :meth:`~repro_torch.serve.microbatch.Microbatcher.retune`
   (TuningConfig-shaped knobs: ``serve_max_batch`` halves/doubles within
   its bounds, ``serve_max_delay_s`` moves geometrically within its
   bounds), and the backpressure signal (p99 above SLO) forwarded to the
   admission controller so the batch QoS lane yields.

Oscillation control is structural, not tuned: the hysteresis band, the
bounded per-tick step, and a **cooldown** after every direction flip — a
reversal attempted within ``cooldown_intervals`` ticks of the previous
flip is *damped* (counted, not applied). An applied flip inside the
cooldown would be a bug in this guard; it is counted separately as
``serve.policy.oscillation_violations`` and CI asserts that counter stays
zero under sustained load.

Every decision is auditable: an instant event ``serve.policy`` (observed
p99, SLO, direction, the knob values written) lands in the Chrome trace,
and gauges/counters mirror the current knobs and adjustment counts.

Contract, same as obs and tune: **the policy changes speed and admission,
never bytes** — any request that completes returns results byte-identical
to the static-config oracle (grouping only decides when a scan runs and
which queries share it).
"""

from __future__ import annotations

from typing import Callable, Iterable

from repro_torch import obs
from repro_torch.obs.metrics import Histogram, Metrics
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.microbatch import Microbatcher

# decision labels (trace vocabulary)
TIGHTEN = "tighten"
RELAX = "relax"
HOLD = "hold"
DAMPED = "damped"
AT_BOUND = "at_bound"


class AdaptiveBatchPolicy:
    """Closed-loop controller over a service's microbatch triggers.

    Construct with the latency SLO and (optionally) explicit knob bounds,
    hand it to :class:`~repro_torch.serve.service.RetrievalService`; the service
    binds it to its batchers, admission controller, and windowed request
    histogram, then drives :meth:`tick` from every ``poll``.

    ``batch_bounds`` / ``delay_bounds`` default at bind time from the
    batcher's own knobs: batch may shrink to ``min_bucket`` and grow to
    the bucket-ladder cap (``max_bucket`` — growing past it would only
    split again), delay may shrink to 0.1 ms and grow to
    ``max(initial delay, slo/4)``.
    """

    def __init__(
        self,
        *,
        slo_p99_s: float,
        interval_s: float = 0.25,
        band: float = 0.2,
        cooldown_intervals: int = 2,
        min_samples: int = 16,
        window_s: float | None = None,
        batch_bounds: tuple[int, int] | None = None,
        delay_bounds: tuple[float, float] | None = None,
    ):
        if slo_p99_s <= 0:
            raise ValueError("slo_p99_s must be positive")
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if not 0.0 < band < 1.0:
            raise ValueError(f"band must be in (0,1): {band}")
        if cooldown_intervals < 1:
            raise ValueError("cooldown_intervals must be >= 1")
        self.slo_p99_s = slo_p99_s
        self.interval_s = interval_s
        self.band = band
        self.cooldown_s = cooldown_intervals * interval_s
        self.min_samples = min_samples
        # the recency horizon of the histogram the policy reads: long
        # enough to hold a few intervals of samples, short enough to
        # forget the previous load level quickly
        self.window_s = window_s if window_s is not None else max(8 * interval_s, 2.0)
        self._batch_bounds = batch_bounds
        self._delay_bounds = delay_bounds

        # bound at bind()
        self._batchers: tuple[Microbatcher, ...] = ()
        self._admission: AdmissionController | None = None
        self._hist: Histogram | None = None
        self._met: Callable[[], Metrics] | None = None

        # controller state
        self._eff_batch: int | None = None
        self._eff_delay: float | None = None
        self._last_tick: float | None = None
        self._last_direction = 0
        self._last_flip_t: float | None = None
        self.adjustments = 0
        self.damped = 0
        self.flips = 0
        self.oscillation_violations = 0

    # -- wiring -------------------------------------------------------------

    def bind(
        self,
        *,
        batchers: Iterable[Microbatcher],
        request_hist: Histogram,
        metrics: Callable[[], Metrics],
        admission: AdmissionController | None = None,
    ) -> None:
        """Attach the policy to one service's moving parts (the service
        calls this once, at construction)."""
        self._batchers = tuple(batchers)
        if not self._batchers:
            raise ValueError("policy needs at least one batcher")
        self._hist = request_hist
        self._met = metrics
        self._admission = admission
        b = self._batchers[0]
        self._eff_batch = min(
            b.max_batch, b.max_bucket if b.max_bucket is not None else b.max_batch
        )
        self._eff_delay = b.max_delay
        if self._batch_bounds is None:
            hi = b.max_bucket if b.max_bucket is not None else max(b.max_batch, 1)
            self._batch_bounds = (b.min_bucket, max(hi, self._eff_batch))
        if self._delay_bounds is None:
            self._delay_bounds = (
                1e-4,
                max(b.max_delay, self.slo_p99_s / 4.0),
            )

    @property
    def effective(self) -> dict:
        """The knobs the policy currently holds (TuningConfig-shaped)."""
        return {
            "serve_max_batch": self._eff_batch,
            "serve_max_delay_s": self._eff_delay,
        }

    # -- the loop -----------------------------------------------------------

    def tick(self, now: float) -> str | None:
        """One control-loop step; returns the decision label or None when
        the tick was skipped (inside the interval, or too few samples)."""
        if self._hist is None:
            raise RuntimeError("policy not bound to a service")
        if self._last_tick is not None and now - self._last_tick < self.interval_s:
            return None
        self._last_tick = now

        n = self._hist.count
        if n < self.min_samples:
            return None
        p99 = self._hist.quantile(0.99)

        # backpressure first: the batch lane yields the moment the SLO is
        # at risk, independent of whether a knob step fires this tick
        if self._admission is not None:
            self._admission.set_pressure(p99 > self.slo_p99_s)

        hi = self.slo_p99_s * (1.0 + self.band)
        lo = self.slo_p99_s * (1.0 - self.band)
        direction = -1 if p99 > hi else (1 if p99 < lo else 0)
        if direction == 0:
            self._trace(now, p99, HOLD)
            return HOLD

        if self._last_direction != 0 and direction != self._last_direction:
            if self._last_flip_t is not None and now - self._last_flip_t < self.cooldown_s:
                # a reversal this soon after the last one is the oscillation
                # signature: damp it (hold the knobs, count the attempt)
                self.damped += 1
                self._counter("serve.policy.damped").inc()
                self._trace(now, p99, DAMPED, direction=direction)
                return DAMPED
            # applied flip: record it, and self-check the guard — a flip
            # landing inside the cooldown would mean the damper is broken
            if self._last_flip_t is not None and now - self._last_flip_t < self.cooldown_s:
                self.oscillation_violations += 1  # pragma: no cover — guard bug
                self._counter("serve.policy.oscillation_violations").inc()
            self.flips += 1
            self._counter("serve.policy.flips").inc()
            self._last_flip_t = now

        b_lo, b_hi = self._batch_bounds
        d_lo, d_hi = self._delay_bounds
        if direction < 0:
            new_batch = max(self._eff_batch // 2, b_lo)
            new_delay = max(self._eff_delay * 0.5, d_lo)
            label = TIGHTEN
        else:
            new_batch = min(self._eff_batch * 2, b_hi)
            new_delay = min(self._eff_delay * 1.5, d_hi)
            label = RELAX
        if new_batch == self._eff_batch and new_delay == self._eff_delay:
            # already pinned at the bound in this direction
            self._last_direction = direction
            self._trace(now, p99, AT_BOUND, direction=direction)
            return AT_BOUND

        self._eff_batch, self._eff_delay = new_batch, new_delay
        self._last_direction = direction
        for batcher in self._batchers:
            batcher.retune(max_batch=new_batch, max_delay=new_delay)
        self.adjustments += 1
        met = self._met()
        met.counter("serve.policy.adjustments").inc()
        met.gauge("serve.policy.max_batch").set(new_batch)
        met.gauge("serve.policy.max_delay_s").set(new_delay)
        self._trace(now, p99, label, direction=direction)
        return label

    # -- plumbing -----------------------------------------------------------

    def _counter(self, name: str):
        return self._met().counter(name)

    def _trace(self, now: float, p99: float, decision: str, *, direction: int = 0):
        obs.tracer().instant(
            "serve.policy",
            "serve",
            decision=decision,
            direction=direction,
            p99_ms=round(p99 * 1e3, 3),
            slo_ms=round(self.slo_p99_s * 1e3, 3),
            serve_max_batch=self._eff_batch,
            serve_max_delay_s=self._eff_delay,
            pressure=self._admission.pressure if self._admission is not None else False,
        )

    def describe(self) -> dict:
        """Policy provenance for reports / BENCH payloads."""
        return {
            "slo_p99_ms": self.slo_p99_s * 1e3,
            "interval_s": self.interval_s,
            "band": self.band,
            "window_s": self.window_s,
            "batch_bounds": list(self._batch_bounds) if self._batch_bounds else None,
            "delay_bounds": list(self._delay_bounds) if self._delay_bounds else None,
            "effective": self.effective,
            "adjustments": self.adjustments,
            "flips": self.flips,
            "damped": self.damped,
            "oscillation_violations": self.oscillation_violations,
        }
