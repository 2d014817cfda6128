"""The retrieval service: admission → microbatch → dispatch → unpad.

Request lifecycle (see docs/ARCHITECTURE.md §Serve):

1. ``try_submit(query, kind, tenant=, lane=)`` consults the admission
   controller (bounded queue, per-tenant token buckets, QoS lanes) and
   either admits the query into the kind's microbatcher — returning a
   typed :class:`~repro_torch.serve.admission.Admitted` with the request id —
   or rejects it with a typed ``Shed``/``Blocked`` (counted in obs,
   traced, never silent). ``submit`` is the legacy/raw surface: it
   bypasses a missing controller entirely and raises on rejection.
2. ``poll()`` first runs the adaptive policy tick (if one is installed:
   the closed loop that retunes the microbatch triggers against the
   latency SLO), then closes every block whose size/deadline trigger has
   fired and dispatches it: lexical blocks to the raw-token chunked scan
   (``scan.search_local``: the lexical kernel), dense blocks to the fused
   score+top-k kernel — one resident-corpus session per kind.
3. Padding rows are stripped and per-request ``SearchResult``s are returned
   keyed by request id; a ``BatchRecord`` per block (real/padded size,
   queue wait, device latency, trigger) lands in ``service.metrics``.

``drain()`` force-flushes at shutdown. The wall clock is injectable so the
deadline trigger is testable; production callers use the monotonic clock.
The open-loop load generator (`repro_torch.serve.loadgen`) drives the same
surface under a virtual clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping

import numpy as np

from repro_torch import obs
from repro_torch.obs.metrics import Metrics
from repro_torch.serve.admission import Admitted, AdmissionController, Blocked, Shed
from repro_torch.serve.microbatch import Microbatcher, QueryBlock, unpad_results
from repro_torch.serve.policy import AdaptiveBatchPolicy
from repro_torch.serve.session import DenseSession, LexicalSession, ShardedLexicalSession


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Per-request top-k, already on host with padding stripped."""

    rid: int
    scores: np.ndarray  # [k] float32, descending
    ids: np.ndarray  # [k] int32 global doc ids


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """Telemetry for one dispatched block (one point on the C1 curve)."""

    kind: str
    n_real: int
    n_padded: int
    trigger: str
    queue_wait_s: float  # oldest request's admission -> block close
    latency_s: float  # dispatch -> results on host

    @property
    def us_per_query(self) -> float:
        return self.latency_s / max(self.n_real, 1) * 1e6

    @property
    def occupancy(self) -> float:
        return self.n_real / max(self.n_padded, 1)


class RejectedError(RuntimeError):
    """``submit`` (the raw, exception-style surface) hit admission control;
    the typed outcome rides along for callers that want the details."""

    def __init__(self, outcome: Shed | Blocked):
        super().__init__(f"request rejected: {outcome}")
        self.outcome = outcome


# batch sizes are small integers bucketed like the padder buckets them:
# powers of two (latency buckets would waste resolution below 1.0)
_BATCH_BOUNDS = tuple(float(1 << i) for i in range(11))  # 1 .. 1024
# occupancy is a fraction: linear buckets resolve the whole [0, 1] range
_OCCUPANCY_BOUNDS = tuple(i / 10 for i in range(1, 11))


class RetrievalService:
    """Dispatcher over resident-corpus sessions, one microbatcher per kind.

    ``admission`` installs enqueue-time load shedding / backpressure and
    QoS lanes (:class:`~repro_torch.serve.admission.AdmissionController`);
    ``policy`` installs the SLO closed loop
    (:class:`~repro_torch.serve.policy.AdaptiveBatchPolicy`) — the service binds
    it to its batchers, the admission controller, and a *windowed* request
    latency histogram (``serve.recent.request_s``) created against the
    service clock, then ticks it from every ``poll``. Neither changes any
    completed request's bytes: admission decides *whether* a query runs,
    the policy decides *when* and *with whom* — results are byte-identical
    to the static-config service for every request that completes.
    """

    def __init__(
        self,
        sessions: Mapping[str, LexicalSession | DenseSession | ShardedLexicalSession],
        *,
        max_batch: int | None = None,
        max_delay: float | None = None,
        min_bucket: int | None = None,
        max_bucket: int | None = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Metrics | None = None,
        tuning=None,
        admission: AdmissionController | None = None,
        policy: AdaptiveBatchPolicy | None = None,
    ):
        if not sessions:
            raise ValueError("need at least one session")
        self.sessions = dict(sessions)
        self._clock = clock
        # ``registry`` pins the service's histograms/counters to one owned
        # Metrics (the launcher's shutdown summary); default is the process
        # registry, resolved per dispatch so obs.session() swaps apply
        self._registry = registry
        # trigger knobs default (None) from `tuning` / the active TuningConfig
        self._batchers = {
            kind: Microbatcher(
                max_batch=max_batch,
                max_delay=max_delay,
                min_bucket=min_bucket,
                max_bucket=max_bucket,
                pad_value=sess.pad_value,
                tuning=tuning,
            )
            for kind, sess in self.sessions.items()
        }
        self._next_rid = 0
        self.metrics: list[BatchRecord] = []
        self.admission = admission
        self.policy = policy
        if policy is not None:
            # the windowed (recent-quantile) histogram the policy reads is
            # created here, against the service clock, so get-or-create
            # races can never hand the policy a cumulative instrument
            hist = self._met().histogram(
                "serve.recent.request_s",
                window_s=policy.window_s,
                clock=self._clock,
            )
            policy.bind(
                batchers=self._batchers.values(),
                request_hist=hist,
                metrics=self._met,
                admission=admission,
            )

    def _met(self) -> Metrics:
        return self._registry if self._registry is not None else obs.metrics()

    @property
    def kinds(self) -> tuple[str, ...]:
        return tuple(self.sessions)

    def _resolve_kind(self, kind: str | None) -> str:
        if kind is None:
            if len(self.sessions) != 1:
                raise ValueError(f"ambiguous kind; service has {self.kinds}")
            return next(iter(self.sessions))
        if kind not in self._batchers:
            raise KeyError(f"no session {kind!r}; available: {self.kinds}")
        return kind

    def try_submit(
        self,
        query: np.ndarray,
        kind: str | None = None,
        *,
        tenant: str = "default",
        lane: str = "interactive",
    ) -> Admitted | Shed | Blocked:
        """Admission-checked submit: returns a typed outcome, never raises
        on rejection. Without an admission controller every request admits."""
        kind = self._resolve_kind(kind)
        now = self._clock()
        met = self._met()
        if self.admission is not None:
            rejection = self.admission.admit(
                tenant=tenant, lane=lane, now=now, queue_depth=self.pending(kind)
            )
            if rejection is not None:
                met.counter("serve.shed").inc()
                met.counter(f"serve.shed.{rejection.reason}").inc()
                met.counter(f"serve.lane.{lane}.shed").inc()
                obs.tracer().instant(
                    "serve.shed",
                    "serve",
                    reason=rejection.reason,
                    lane=lane,
                    tenant=tenant,
                    kind=kind,
                    blocked=isinstance(rejection, Blocked),
                )
                return rejection
        rid = self._next_rid
        self._next_rid += 1
        self._batchers[kind].submit(rid, query, now)
        met.counter("serve.admitted").inc()
        met.counter(f"serve.lane.{lane}.admitted").inc()
        return Admitted(rid=rid, lane=lane, tenant=tenant)

    def submit(self, query: np.ndarray, kind: str | None = None) -> int:
        """Admit one query; returns its request id without blocking.

        The raw surface: with no admission controller installed this is
        unconditional (the historical behavior); with one, a rejection
        raises :class:`RejectedError` — callers that want shed/blocked as
        data use :meth:`try_submit`.
        """
        outcome = self.try_submit(query, kind)
        if not outcome.admitted:
            raise RejectedError(outcome)
        return outcome.rid

    def pending(self, kind: str | None = None) -> int:
        if kind is not None:
            return len(self._batchers[kind])
        return sum(len(b) for b in self._batchers.values())

    def _dispatch(self, kind: str, block: QueryBlock) -> dict[int, SearchResult]:
        session = self.sessions[kind]
        tr = obs.tracer()
        t0 = self._clock()
        with tr.span(
            "serve.dispatch", "serve",
            kind=kind, n_real=block.n_real, n_padded=block.n_padded,
            trigger=block.trigger,
        ):
            state = session.search(block.queries)
        latency = self._clock() - t0
        self.metrics.append(
            BatchRecord(
                kind=kind,
                n_real=block.n_real,
                n_padded=block.n_padded,
                trigger=block.trigger,
                queue_wait_s=block.closed_at - block.oldest_arrival,
                latency_s=latency,
            )
        )
        met = self._met()
        met.counter("serve.requests").inc(block.n_real)
        met.counter("serve.batches").inc()
        met.histogram("serve.batch_size", bounds=_BATCH_BOUNDS).observe(block.n_real)
        met.histogram(
            "serve.batch_occupancy", bounds=_OCCUPANCY_BOUNDS
        ).observe(block.n_real / block.n_padded)
        met.histogram("serve.queue_wait_s").observe(
            block.closed_at - block.oldest_arrival
        )
        met.histogram("serve.latency_s").observe(latency)
        # per-request lifecycle spans (enqueue → reply), recorded at reply
        # time on the service clock (== the tracer clock in production)
        done = self._clock()
        request_hist = met.histogram("serve.request_s")
        recent = (
            met.histogram("serve.recent.request_s") if self.policy is not None else None
        )
        for rid, arrival in zip(block.rids, block.arrivals):
            tr.record("serve.request", arrival, done, "serve", rid=rid, kind=kind)
            request_hist.observe(done - arrival)
            if recent is not None:
                recent.observe(done - arrival)
        scores = unpad_results(np.asarray(state.scores), block.n_real)
        ids = unpad_results(np.asarray(state.ids), block.n_real)
        return {
            rid: SearchResult(rid=rid, scores=scores[row], ids=ids[row])
            for row, rid in enumerate(block.rids)
        }

    def poll(self, limit: int | None = None) -> dict[int, SearchResult]:
        """Dispatch every block whose size/deadline trigger has fired
        (at most ``limit`` blocks when given — the load generator uses
        ``limit=1`` to timestamp completions per block). Runs the adaptive
        policy tick first, so trigger changes apply to the blocks this
        poll closes."""
        if self.policy is not None:
            self.policy.tick(self._clock())
        out: dict[int, SearchResult] = {}
        dispatched = 0
        for kind, batcher in self._batchers.items():
            while (block := batcher.pop_block(self._clock())) is not None:
                out.update(self._dispatch(kind, block))
                dispatched += 1
                if limit is not None and dispatched >= limit:
                    return out
        return out

    def drain(self) -> dict[int, SearchResult]:
        """Force-flush all pending queries (shutdown / end of stream)."""
        out: dict[int, SearchResult] = {}
        for kind, batcher in self._batchers.items():
            for block in batcher.drain(self._clock()):
                out.update(self._dispatch(kind, block))
        return out

    def next_deadline(self) -> float | None:
        """Earliest pending deadline across kinds (event-loop sleep hint)."""
        deadlines = [
            d for b in self._batchers.values() if (d := b.next_deadline()) is not None
        ]
        return min(deadlines) if deadlines else None

    def ready_at(self, now: float) -> float | None:
        """Earliest time ``>= now`` at which some batcher's trigger will
        have fired: ``now`` itself if a block is already ready (size
        trigger, or an expired deadline), else the earliest pending
        deadline; None when nothing is queued. The load generator's event
        source for 'when could the server next start a dispatch'."""
        best: float | None = None
        for b in self._batchers.values():
            if b.ready(now):
                return now
            d = b.next_deadline()
            if d is not None and (best is None or d < best):
                best = d
        return best
