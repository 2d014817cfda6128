"""Deterministic fault injection for sharded scan jobs (the port of
`repro.cluster.faults`: the same kinds, matching, CLI syntax and seeded
schedules, so one seed gives the reference's schedule).

The paper's reliability story is Hadoop's: machines die, disks fail, and
some workers are just slow, yet the job finishes and the answer doesn't
change. To *test* that story we need faults that are injectable on demand,
deterministic under a seed, and visible to assertions — not a single
hard-coded ``fail_at_segment`` RuntimeError.

A :class:`FaultSpec` names one fault; a :class:`FaultSchedule` is a set of
specs that `repro_torch.cluster.job.run_scan_job` consults at each
injection point of the per-segment loop:

* **crash** — the worker process "dies" on a shard, either *before* the
  segment's checkpoint commits (work since the last commit is lost) or
  *after* it (the canonical lost-ack kill: the commit is durable but never
  acknowledged). Raises :class:`WorkerCrash`.
* **writer_error** — the checkpoint writer fails mid-commit (disk full,
  I/O error) via the `repro_torch.checkpoint.save` ``on_commit`` hook, so
  the atomic rename never happens and a ``.tmp`` dir is left behind —
  exactly the poisoned-dir state a real I/O fault leaves. Raises
  :class:`InjectedWriterError` (an ``OSError``).
* **straggler** — the shard still produces correct results, just slowly:
  a per-segment delay, the speculative-execution trigger.
* **dead_worker** — a *scheduler worker* (not a shard) stops picking up
  work, optionally after completing a few shards; the work queue must
  drain through the surviving workers (work stealing).

Faults match on ``(shard, segment, attempt)`` — ``attempts=(0,)`` (the
default for crashes and writer errors) makes a fault *transient*: it fires
on the first execution attempt and lets the retry succeed, which is how
real lost machines behave from the scheduler's point of view.
``attempts="all"`` makes it *permanent* (the retry-exhaustion path).
Matching is stateless, so the same schedule object drives a sequential
reference run and a concurrent scheduled run identically; every fault that
actually fires is recorded in :attr:`FaultSchedule.fired` for assertions.

:func:`FaultSchedule.random` derives a whole chaos schedule from one seed
(crash × phase × straggler × writer-error per shard), so a CI matrix is
``for seed in 0 1 2`` instead of a hand-enumerated fault zoo.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch import obs

KINDS = ("crash", "writer_error", "straggler", "dead_worker")
PHASES = ("pre_commit", "post_commit")


class InjectedFault(RuntimeError):
    """Base of all injected failures (stragglers are delays, not errors)."""


class WorkerCrash(InjectedFault):
    """An injected worker death. Subclasses RuntimeError with the historic
    "injected failure" message so pre-FaultSpec tests and CI keep matching."""


class InjectedWriterError(OSError):
    """An injected checkpoint-writer I/O failure (poisons the async writer)."""


class ShardCancelled(Exception):
    """A shard attempt stopped because a rival copy committed first.

    Not a failure: the scheduler treats it as a clean discard (it never
    counts against ``max_retries`` and never surfaces to the caller).
    """


def _normalize_attempts(kind: str, attempts) -> tuple[int, ...] | None:
    """``None`` means "every attempt" (permanent); tuples are explicit."""
    if attempts == "auto":
        # crashes and writer errors default to transient (first attempt
        # only — the retry succeeds); stragglers and dead workers are
        # conditions, not events, so they default to permanent
        return (0,) if kind in ("crash", "writer_error") else None
    if attempts in ("all", None):
        return None
    if isinstance(attempts, int):
        return (attempts,)
    return tuple(int(a) for a in attempts)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault. ``shard=None`` / ``segment=None`` mean "any"."""

    kind: str
    shard: int | None = None
    segment: int | None = None
    phase: str = "post_commit"  # crash only: pre_commit | post_commit
    attempts: tuple[int, ...] | str | None = "auto"
    delay_s: float = 0.0  # straggler: sleep per matching segment
    worker: int | None = None  # dead_worker: which scheduler worker dies
    after_shards: int = 0  # dead_worker: die after completing this many

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.phase not in PHASES:
            raise ValueError(f"unknown crash phase {self.phase!r}; one of {PHASES}")
        if self.kind in ("crash", "writer_error") and self.segment is None:
            raise ValueError(f"{self.kind} fault needs an explicit segment")
        if self.kind == "straggler" and self.delay_s < 0:
            raise ValueError(f"straggler delay must be >= 0, got {self.delay_s}")
        if self.kind == "dead_worker" and self.worker is None:
            raise ValueError("dead_worker fault needs an explicit worker")
        object.__setattr__(
            self, "attempts", _normalize_attempts(self.kind, self.attempts)
        )

    def matches(self, shard: int, segment: int, attempt: int) -> bool:
        return (
            (self.shard is None or self.shard == shard)
            and (self.segment is None or self.segment == segment)
            and (self.attempts is None or attempt in self.attempts)
        )

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["attempts"] = "all" if self.attempts is None else list(self.attempts)
        return d


def parse_fault(spec: str) -> FaultSpec:
    """Parse the CLI syntax ``kind:key=val,key=val`` into a :class:`FaultSpec`.

    Examples: ``crash:shard=1,segment=0,phase=pre_commit``,
    ``writer_error:shard=0,segment=1``, ``straggler:shard=2,delay=0.05``,
    ``dead_worker:worker=0``, ``crash:shard=3,segment=0,attempts=all``.
    """
    kind, _, params = spec.partition(":")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {spec!r}; one of {KINDS}")
    kwargs: dict = {}
    if params:
        for item in params.split(","):
            key, sep, val = item.partition("=")
            if not sep or not val:
                raise ValueError(f"malformed fault param {item!r} in {spec!r}")
            if key == "delay":
                key = "delay_s"
            if key in ("shard", "segment", "worker", "after_shards"):
                kwargs[key] = int(val)
            elif key == "delay_s":
                kwargs[key] = float(val)
            elif key == "attempts":
                kwargs[key] = "all" if val == "all" else tuple(
                    int(a) for a in val.split("|")
                )
            elif key == "phase":
                kwargs[key] = val
            else:
                raise ValueError(f"unknown fault param {key!r} in {spec!r}")
    return FaultSpec(kind=kind, **kwargs)


class FaultSchedule:
    """A set of :class:`FaultSpec`\\ s plus a thread-safe log of fired faults.

    Matching is stateless (pure function of ``(shard, segment, attempt)``),
    so one schedule drives any executor; the :attr:`fired` log records what
    actually happened, for test assertions and report counters.
    """

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: tuple[FaultSpec, ...] = tuple(specs)
        self._lock = threading.Lock()
        self._fired: list[dict] = []
        self._dead_recorded: set[int] = set()

    # -- construction --------------------------------------------------------

    def add(self, spec: FaultSpec) -> "FaultSchedule":
        """Append a spec in place (keeps the caller's ``fired`` log live)."""
        self.specs = self.specs + (spec,)
        return self

    @classmethod
    def from_legacy(cls, fail_at_segment: int, fail_at_shard: int) -> "FaultSchedule":
        """The deprecated ``fail_at_segment``/``fail_at_shard`` kwargs as a
        schedule: one transient post-commit crash on one shard — the only
        fault the pre-FaultSpec plumbing could express."""
        return cls(
            [
                FaultSpec(
                    kind="crash",
                    shard=fail_at_shard,
                    segment=fail_at_segment,
                    phase="post_commit",
                )
            ]
        )

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        n_shards: int,
        n_segments: int,
        p_crash: float = 0.5,
        p_straggler: float = 0.5,
        p_writer_error: float = 0.25,
        max_delay_s: float = 0.02,
    ) -> "FaultSchedule":
        """A seeded chaos schedule: per shard, maybe a transient crash (random
        segment × random phase), maybe a writer error, maybe a straggler
        delay. Always contains at least one crash so every seed exercises the
        retry path. Deterministic: same seed → same schedule."""
        rng = np.random.default_rng(seed)
        specs: list[FaultSpec] = []
        for shard in range(n_shards):
            if rng.random() < p_crash:
                specs.append(
                    FaultSpec(
                        kind="crash",
                        shard=shard,
                        segment=int(rng.integers(n_segments)),
                        phase=PHASES[int(rng.integers(2))],
                    )
                )
            if rng.random() < p_writer_error:
                specs.append(
                    FaultSpec(
                        kind="writer_error",
                        shard=shard,
                        segment=int(rng.integers(n_segments)),
                    )
                )
            if rng.random() < p_straggler:
                specs.append(
                    FaultSpec(
                        kind="straggler",
                        shard=shard,
                        delay_s=float(rng.uniform(0.25, 1.0) * max_delay_s),
                    )
                )
        if not any(s.kind == "crash" for s in specs):
            specs.append(
                FaultSpec(
                    kind="crash",
                    shard=int(rng.integers(n_shards)),
                    segment=int(rng.integers(n_segments)),
                    phase=PHASES[int(rng.integers(2))],
                )
            )
        return cls(specs)

    # -- bookkeeping ---------------------------------------------------------

    def _record(self, spec: FaultSpec, **ctx) -> None:
        with self._lock:
            self._fired.append({"kind": spec.kind, **ctx})
        # every firing doubles as a trace marker on the injecting thread —
        # recording only; no control flow ever depends on the tracer
        obs.tracer().instant(f"fault.{spec.kind}", "fault", **ctx)

    @property
    def fired(self) -> list[dict]:
        """Snapshot of every fault that actually fired (thread-safe copy)."""
        with self._lock:
            return list(self._fired)

    def count_fired(self, kind: str) -> int:
        with self._lock:
            return sum(1 for e in self._fired if e["kind"] == kind)

    def describe(self) -> list[dict]:
        return [s.describe() for s in self.specs]

    # -- injection points (called from the per-segment loop) -----------------

    def maybe_delay(
        self, shard: int, segment: int, attempt: int, cancel=None
    ) -> float:
        """Apply every matching straggler delay; returns seconds slept.

        ``cancel`` (a ``threading.Event``) makes the sleep interruptible so
        a cancelled straggler stops promptly instead of finishing its nap.
        """
        total = 0.0
        for spec in self.specs:
            if spec.kind == "straggler" and spec.matches(shard, segment, attempt):
                total += spec.delay_s
        if total > 0.0:
            self._record(
                FaultSpec(kind="straggler", delay_s=total),
                shard=shard, segment=segment, attempt=attempt, delay_s=total,
            )
            if cancel is not None:
                cancel.wait(total)
            else:
                time.sleep(total)
        return total

    def crash_at(
        self, shard: int, segment: int, attempt: int, phase: str
    ) -> FaultSpec | None:
        """The matching crash spec for this ``phase``, recorded — or None."""
        for spec in self.specs:
            if (
                spec.kind == "crash"
                and spec.phase == phase
                and spec.matches(shard, segment, attempt)
            ):
                self._record(
                    spec, shard=shard, segment=segment, attempt=attempt, phase=phase
                )
                return spec
        return None

    def commit_hook(
        self, shard: int, segment: int, attempt: int
    ) -> Callable[[int, str], None] | None:
        """An ``on_commit`` hook for :func:`repro_torch.checkpoint.save` that fails
        the commit *before* the atomic rename — or None when no writer-error
        spec matches. The raise happens on whichever thread runs the save
        (the async writer's, usually), poisoning it exactly like a real I/O
        error would."""
        for spec in self.specs:
            if spec.kind == "writer_error" and spec.matches(shard, segment, attempt):

                def fail_commit(step: int, tmp_dir: str, _spec=spec) -> None:
                    self._record(
                        _spec, shard=shard, segment=segment, attempt=attempt
                    )
                    raise InjectedWriterError(
                        f"injected checkpoint-writer error on shard {shard} "
                        f"segment {segment} (attempt {attempt})"
                    )

                return fail_commit
        return None

    def worker_dead(self, worker: int, shards_done: int) -> bool:
        """True when scheduler worker ``worker`` should stop taking work."""
        for spec in self.specs:
            if (
                spec.kind == "dead_worker"
                and spec.worker == worker
                and shards_done >= spec.after_shards
            ):
                with self._lock:
                    fresh = worker not in self._dead_recorded
                    if fresh:
                        self._dead_recorded.add(worker)
                        self._fired.append(
                            {"kind": "dead_worker", "worker": worker,
                             "after_shards": shards_done}
                        )
                if fresh:
                    obs.tracer().instant(
                        "fault.dead_worker", "fault",
                        worker=worker, after_shards=shards_done,
                    )
                return True
        return False


def build_schedule(specs: Sequence[str]) -> FaultSchedule:
    """Parse a list of CLI fault strings into one schedule."""
    return FaultSchedule([parse_fault(s) for s in specs])
