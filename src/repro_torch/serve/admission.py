"""Per-session admission control and backpressure: decide *at enqueue time*.

A production retrieval service cannot admit unboundedly: past the knee of
the open-loop load curve, every admitted request makes every other request
later, and the queue — not the scan — becomes the latency. This module is
the gate in front of the microbatcher:

* a **bounded admission queue** — when the pending depth reaches
  ``queue_limit``, new arrivals are rejected (shed) or asked to retry
  (block), instead of growing an unbounded backlog;
* **per-tenant token buckets** — each (tenant, lane) pair can carry a
  sustained-rate + burst budget, so one tenant cannot starve the rest;
* **two-tier QoS lanes** — ``interactive`` and ``batch``. The batch lane
  *yields under pressure*: it is admitted only below a fractional
  watermark of the queue limit, and not at all while the adaptive policy
  reports the latency SLO at risk (`set_pressure`). Interactive traffic
  keeps the full queue.

Decisions are **typed results**, not exceptions: :class:`Admitted` /
:class:`Shed` / :class:`Blocked`. The service layer counts every decision
in the obs metrics registry (``serve.admitted`` / ``serve.shed`` +
per-reason and per-lane counters) and traces sheds, so load-shedding is
auditable, never silent.

The contract mirrors the rest of the serving layer: admission changes
*which* requests run and *when* — never the bytes of any request that
completes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

INTERACTIVE = "interactive"
BATCH = "batch"
LANES = (INTERACTIVE, BATCH)

# shed reasons (the typed-result / counter vocabulary)
QUEUE_FULL = "queue_full"
RATE_LIMITED = "rate_limited"
BATCH_YIELD = "batch_yield"


@dataclasses.dataclass(frozen=True)
class Admitted:
    """The request entered the microbatch queue; ``rid`` is live."""

    rid: int
    lane: str = INTERACTIVE
    tenant: str = "default"

    @property
    def admitted(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Shed:
    """The request was rejected at enqueue time and will never run."""

    reason: str  # queue_full | rate_limited | batch_yield
    lane: str = INTERACTIVE
    tenant: str = "default"

    @property
    def admitted(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Blocked:
    """Backpressure: not admitted now, retry later (``retry_at`` is a
    clock hint when one exists — token refill time — else None, meaning
    'after the next dispatch drains the queue')."""

    reason: str
    lane: str = INTERACTIVE
    tenant: str = "default"
    retry_at: float | None = None

    @property
    def admitted(self) -> bool:
        return False


class TokenBucket:
    """The classic leaky budget: ``rate`` tokens/s refill up to ``burst``.

    Time is injected per call (same discipline as the microbatcher), so
    bucket behavior is deterministic under test and under the virtual
    clock of the open-loop load generator.
    """

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be positive: {rate}, {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: float | None = None

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        if self._last is None or now > self._last:
            self._last = now

    def peek(self, now: float) -> float:
        self._refill(now)
        return self._tokens

    def take(self, now: float) -> bool:
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def next_token_at(self, now: float) -> float:
        """Earliest time a full token will be available (a Blocked hint)."""
        self._refill(now)
        if self._tokens >= 1.0:
            return now
        return now + (1.0 - self._tokens) / self.rate


class AdmissionController:
    """The shed-or-block gate in front of a service's microbatchers.

    ``queue_limit`` bounds the *pending* request count the controller will
    admit into (the service passes the live depth per decision — the
    controller holds no queue of its own). ``batch_watermark`` is the
    fraction of ``queue_limit`` above which the batch lane yields;
    ``on_full`` picks the decision type for a full queue (``"shed"`` drops
    with a typed result, ``"block"`` asks the caller to retry).

    Rates are optional: a (tenant, lane) with no bucket is uncapped.
    ``set_rate`` installs one; ``"*"`` as tenant installs a per-lane
    default applied to tenants without their own bucket (each such tenant
    still gets its *own* bucket instance at the default rate — a shared
    default must not make tenants share a budget).
    """

    def __init__(
        self,
        *,
        queue_limit: int = 256,
        batch_watermark: float = 0.5,
        on_full: str = "shed",
    ):
        if queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if not 0.0 <= batch_watermark <= 1.0:
            raise ValueError(f"batch_watermark must be in [0,1]: {batch_watermark}")
        if on_full not in ("shed", "block"):
            raise ValueError(f"on_full must be 'shed' or 'block': {on_full!r}")
        self.queue_limit = queue_limit
        self.batch_watermark = batch_watermark
        self.on_full = on_full
        self._buckets: dict[tuple[str, str], TokenBucket] = {}
        self._default_rates: dict[str, tuple[float, float]] = {}  # lane -> (rate, burst)
        self._pressure = False

    # -- configuration ------------------------------------------------------

    def set_rate(self, tenant: str, lane: str, rate: float, burst: float) -> None:
        """Install a token bucket for (tenant, lane); tenant ``"*"`` sets
        the per-lane default for tenants without an explicit bucket."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; lanes: {LANES}")
        if tenant == "*":
            self._default_rates[lane] = (rate, burst)
        else:
            self._buckets[(tenant, lane)] = TokenBucket(rate, burst)

    def set_pressure(self, pressure: bool) -> None:
        """The adaptive policy's backpressure signal: while True, the batch
        lane yields entirely (interactive keeps the queue)."""
        self._pressure = bool(pressure)

    @property
    def pressure(self) -> bool:
        return self._pressure

    def _bucket(self, tenant: str, lane: str) -> TokenBucket | None:
        b = self._buckets.get((tenant, lane))
        if b is None and lane in self._default_rates:
            rate, burst = self._default_rates[lane]
            b = self._buckets[(tenant, lane)] = TokenBucket(rate, burst)
        return b

    # -- the decision -------------------------------------------------------

    def admit(
        self, *, tenant: str, lane: str, now: float, queue_depth: int
    ) -> Shed | Blocked | None:
        """One enqueue-time decision. Returns ``None`` to admit, else the
        typed rejection. Decision order: rate limit (cheapest to recover
        from — the bucket refills), then queue bound, then QoS yield."""
        if lane not in LANES:
            raise ValueError(f"unknown lane {lane!r}; lanes: {LANES}")
        bucket = self._bucket(tenant, lane)
        if bucket is not None and not bucket.take(now):
            if self.on_full == "block":
                return Blocked(
                    RATE_LIMITED, lane, tenant, retry_at=bucket.next_token_at(now)
                )
            return Shed(RATE_LIMITED, lane, tenant)
        if queue_depth >= self.queue_limit:
            if self.on_full == "block":
                return Blocked(QUEUE_FULL, lane, tenant)
            return Shed(QUEUE_FULL, lane, tenant)
        if lane == BATCH and (
            self._pressure or queue_depth >= self.batch_watermark * self.queue_limit
        ):
            # batch yields: under pressure or above its watermark the lane
            # gives its queue headroom to interactive traffic
            if self.on_full == "block":
                return Blocked(BATCH_YIELD, lane, tenant)
            return Shed(BATCH_YIELD, lane, tenant)
        return None

    def describe(self) -> dict:
        return {
            "queue_limit": self.queue_limit,
            "batch_watermark": self.batch_watermark,
            "on_full": self.on_full,
            "pressure": self._pressure,
            "buckets": sorted(f"{t}/{l}" for (t, l) in self._buckets),
        }
