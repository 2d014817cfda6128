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
   A session that offers ``launch``/``collect`` (`session.LexicalSession`)
   keeps blocks in flight: a block's dispatch returns while the card
   works, and a later ``poll`` collects it once it is done. A full block
   may launch behind one still on the card, never a second one; any other
   block waits until nothing is in flight. Other sessions dispatch and
   answer within the call, as do all on the CPU, where a launch completes
   at once.
3. Padding rows are stripped and per-request ``SearchResult``s are returned
   keyed by request id; a ``BatchRecord`` per block (real/padded size,
   queue wait, device latency, trigger) lands in ``service.metrics``.

``drain()`` force-flushes at shutdown. The wall clock is injectable so the
deadline trigger is testable; production callers use the monotonic clock.
The open-loop load generator (`repro_torch.serve.loadgen`) drives the same
surface under a virtual clock.
"""

from __future__ import annotations

import collections
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


def _launches(session) -> bool:
    """Whether ``session`` can launch a block and collect it later. Looked
    up on its class, so that a wrapper delegating every attribute
    (`loadgen.MeteredSession`, which times each ``search``) stays
    synchronous."""
    cls = type(session)
    return callable(getattr(cls, "launch", None)) and callable(getattr(cls, "collect", None))


@dataclasses.dataclass
class _InFlight:
    """A dispatched block not yet answered: the session's handle, or the
    state a synchronous session returned; its number and its launch time on
    the service clock; whether it launched behind a block on the card."""

    kind: str
    block: QueryBlock
    n: int
    t0: float
    behind: bool
    handle: object = None
    state: object = None

    def done(self) -> bool:
        return self.handle is None or self.handle.done()


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
        self._launches = {kind: _launches(sess) for kind, sess in self.sessions.items()}
        self._in_flight: collections.deque[_InFlight] = collections.deque()
        self._next_rid = 0
        self._next_block = 0
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

    def _launch(self, kind: str, block: QueryBlock) -> None:
        """Dispatch one closed block: launch it, or search it through a
        synchronous session, and queue it in flight.

        Traced, a block is ``serve.batch_wait`` (its oldest admission to its
        close), ``serve.dispatch`` (its launch to its results on the host,
        holding the session's and the scan's spans; ``behind`` 1 when it
        launched while another block was on the card) and ``serve.reply``
        (everything after the results), each tagged with the block's number,
        plus one ``serve.request`` a request (admission to reply, same tag)
        on the service's request lane, apart from the thread's own. The
        wait, the dispatch and the requests are recorded from the block's
        times on the service clock, which is the tracer's clock in
        production.
        """
        session = self.sessions[kind]
        tr = obs.tracer()
        n = self._next_block
        self._next_block += 1
        behind = bool(self._in_flight)
        if behind:
            self._met().counter("serve.launched_behind").inc()
        with tr.tags(block=n):
            tr.record("serve.batch_wait", block.oldest_arrival, block.closed_at, "serve",
                      trigger=block.trigger, n_real=block.n_real)
            f = _InFlight(kind, block, n, self._clock(), behind)
            if self._launches[kind]:
                f.handle = session.launch(block.queries)
            else:
                f.state = session.search(block.queries)
        self._in_flight.append(f)

    def _collect(self, f: _InFlight) -> dict[int, SearchResult]:
        """Wait for an in-flight block's results and build its replies."""
        tr = obs.tracer()
        block, kind = f.block, f.kind
        queue_wait = block.closed_at - block.oldest_arrival
        with tr.tags(block=f.n):
            state = f.state if f.handle is None else self.sessions[kind].collect(f.handle)
            landed = self._clock()
            latency = landed - f.t0
            tr.record("serve.dispatch", f.t0, landed, "serve",
                      kind=kind, n_real=block.n_real, n_padded=block.n_padded,
                      trigger=block.trigger, behind=int(f.behind))
            with tr.span("serve.reply", "serve"):
                self.metrics.append(
                    BatchRecord(
                        kind=kind,
                        n_real=block.n_real,
                        n_padded=block.n_padded,
                        trigger=block.trigger,
                        queue_wait_s=queue_wait,
                        latency_s=latency,
                    )
                )
                met = self._met()
                met.counter("serve.requests").inc(block.n_real)
                met.counter("serve.batches").inc()
                met.histogram("serve.batch_size", bounds=_BATCH_BOUNDS).observe(block.n_real)
                met.histogram("serve.queue_wait_s").observe(queue_wait)
                met.histogram("serve.latency_s").observe(latency)
                done = self._clock()
                recent = (
                    met.histogram("serve.recent.request_s")
                    if self.policy is not None else None
                )
                for rid, arrival in zip(block.rids, block.arrivals):
                    tr.record("serve.request", arrival, done, "serve", tid=id(self),
                              rid=rid, kind=kind)
                    if recent is not None:
                        recent.observe(done - arrival)
                scores = unpad_results(np.asarray(state.scores), block.n_real)
                ids = unpad_results(np.asarray(state.ids), block.n_real)
                return {
                    rid: SearchResult(rid=rid, scores=scores[row], ids=ids[row])
                    for row, rid in enumerate(block.rids)
                }

    def _may_launch(self, kind: str) -> bool:
        """Nothing is in flight, or one block is still on the card and
        ``kind``'s session launches without waiting."""
        if not self._in_flight:
            return True
        return (len(self._in_flight) == 1 and self._launches[kind]
                and not self._in_flight[0].done())

    def _launch_ready(self) -> None:
        """Launch what may launch now: with nothing in flight, each block
        whose trigger has fired, one at a time; behind a block still on the
        card, one full block. A partial block, even past its deadline, stays
        open behind a running block and gathers requests until that block
        is answered or it fills: a block's fixed cost on the card is high,
        so a small one queued early costs throughput."""
        for kind, batcher in self._batchers.items():
            while self._may_launch(kind) and (not self._in_flight or batcher.full()):
                block = batcher.pop_block(self._clock())
                if block is None:
                    break
                self._launch(kind, block)

    def poll(self, limit: int | None = None) -> dict[int, SearchResult]:
        """Launch every block that may launch, and answer the in-flight
        blocks whose results are on the host, oldest first (at most
        ``limit`` blocks when given — the load generator uses ``limit=1``
        to timestamp completions per block). Runs the adaptive policy tick
        first, so trigger changes apply to the blocks this poll closes.
        Returns without waiting for a block still on the card."""
        if self.policy is not None:
            self.policy.tick(self._clock())
        out: dict[int, SearchResult] = {}
        answered = 0
        while limit is None or answered < limit:
            self._launch_ready()
            if not self._in_flight or not self._in_flight[0].done():
                break
            out.update(self._collect(self._in_flight.popleft()))
            answered += 1
        return out

    def drain(self) -> dict[int, SearchResult]:
        """Force-flush all pending queries (shutdown / end of stream):
        launch every remaining block, wait for everything in flight, and
        return it all."""
        out: dict[int, SearchResult] = {}
        for kind, batcher in self._batchers.items():
            for block in batcher.drain(self._clock()):
                while not self._may_launch(kind):
                    out.update(self._collect(self._in_flight.popleft()))
                self._launch(kind, block)
        while self._in_flight:
            out.update(self._collect(self._in_flight.popleft()))
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
        trigger, or an expired deadline) or a block is in flight (its
        results may land at any moment), else the earliest pending
        deadline; None when nothing is queued. The load generator's event
        source for 'when could the server next start a dispatch'."""
        if self._in_flight:
            return now
        best: float | None = None
        for b in self._batchers.values():
            if b.ready(now):
                return now
            d = b.next_deadline()
            if d is not None and (best is None or d < best):
                best = d
        return best
