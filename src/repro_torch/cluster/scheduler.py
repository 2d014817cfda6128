"""Straggler-tolerant shard scheduler — the MapReduce reliability layer
(the port of `repro.cluster.scheduler`; plain Python threads, no device code).

The paper runs 15 cheap machines for days and leans entirely on Hadoop to
survive them: failed tasks are re-executed from their input split, idle
machines steal queued work, and near the end of a job the slowest running
tasks are *speculatively* duplicated, first copy to finish wins. This
module is that layer for `repro_torch.cluster.run_sharded_scan_job`:

* **work queue, not static assignment** — shards are a queue; ``n_workers``
  threads (one per assigned device) pull from it, so an idle worker steals
  whatever shard is next instead of idling behind its round-robin
  assignment, and a dead worker's backlog drains through the survivors.
* **retry with capped exponential backoff** — a failed shard attempt is
  re-enqueued (``backoff_base * 2**(failures-1)``, capped) and *resumes
  from its last committed segment checkpoint*: the chunk-aligned per-shard
  checkpoint dirs from the plan layer are the unit of re-execution, so a
  retry replays only the lost tail. After ``max_retries`` re-runs the
  shard is declared dead and the job surfaces the shard's *original*
  error (deterministically: the lowest-indexed failed shard's).
* **speculative execution** — when the queue drains, idle workers clone
  the longest-running in-flight shard: the clone seeds its own checkpoint
  dir from the primary's last committed segment and re-executes the tail.
  First attempt to finish commits its result; the rival is cancelled (a
  cooperative per-segment check) and, if the clone won, its checkpoint dir
  is promoted over the primary's via the atomic dir replace — so the
  on-disk state always describes the winning lineage.

Byte-identity survives all of it by construction: every attempt of a shard
folds the same chunk-aligned segment stream through the same fold, so
whichever attempt wins produces the same ``TopKState`` bits, and the
plan-ordered value-deterministic reduce erases scheduling history from the
merged result. The chaos suite (`tests/test_torch_faults.py`) pins that
equality against the fault-free single-host oracle under seeded schedules.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

from repro_torch import obs
from repro_torch.cluster.faults import FaultSchedule, ShardCancelled
from repro_torch.cluster.plan import ShardPlan
from repro_torch.tune import config as tune_config
from repro_torch.tune.config import TuningConfig


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """What the reliability layer actually did — for reports and tests."""

    n_workers: int
    attempts: tuple[int, ...]  # executions per shard (primary + speculative)
    retries: int  # failed attempts that were re-enqueued
    steals: int  # shards run by a worker other than their round-robin home
    speculative_launched: int
    speculative_won: int
    dead_workers: tuple[int, ...]

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["attempts"] = list(self.attempts)
        d["dead_workers"] = list(self.dead_workers)
        return d


@dataclasses.dataclass
class _Task:
    shard: int
    attempt: int
    speculative: bool
    ready_at: float  # monotonic deadline for backoff re-runs


@dataclasses.dataclass
class _Running:
    attempt: int
    speculative: bool
    cancel: threading.Event
    started_at: float


class ShardScheduler:
    """Run every shard of ``plan`` through ``run_attempt`` with retries,
    work stealing, and optional speculation.

    ``run_attempt(shard, worker=, attempt=, cancel=, speculative=)`` must
    return the shard's result, raise :class:`ShardCancelled` when it
    observes its cancel event, or raise anything else to mean "this attempt
    failed". ``finalize_spec(shard_index, won)`` is called exactly once for
    every shard that had a speculative clone, after *both* attempts have
    stopped — the hook promotes or discards the clone's checkpoint dir.
    """

    def __init__(
        self,
        plan: ShardPlan,
        run_attempt: Callable[..., Any],
        *,
        n_workers: int,
        max_retries: int = 0,
        backoff_base: float | None = None,
        backoff_cap: float | None = None,
        speculative: bool = False,
        faults: FaultSchedule | None = None,
        finalize_spec: Callable[[int, bool], None] | None = None,
        tuning: TuningConfig | None = None,
    ):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        cfg = tune_config.resolve(tuning)
        self.plan = plan
        self.run_attempt = run_attempt
        self.n_workers = n_workers
        self.max_retries = max_retries
        self.backoff_base = cfg.backoff_base if backoff_base is None else backoff_base
        self.backoff_cap = cfg.backoff_cap if backoff_cap is None else backoff_cap
        self.speculative = speculative
        self.faults = faults
        self.finalize_spec = finalize_spec

        self._cond = threading.Condition()
        self._queue: list[_Task] = [
            _Task(shard=s.index, attempt=0, speculative=False, ready_at=0.0)
            for s in plan.shards
        ]
        self._running: dict[int, list[_Running]] = {}
        self._results: dict[int, Any] = {}
        self._spec_won: dict[int, bool] = {}
        self._failures: dict[int, int] = {}
        self._first_error: dict[int, BaseException] = {}
        self._failed: set[int] = set()
        self._attempt_counter: dict[int, int] = {s.index: 1 for s in plan.shards}
        self._attempts_run: dict[int, int] = {s.index: 0 for s in plan.shards}
        self._speculated: set[int] = set()
        self._abort = False
        self._retries = 0
        self._steals = 0
        self._spec_launched = 0
        self._dead_workers: list[int] = []

    # -- public -------------------------------------------------------------

    def run(self) -> tuple[list[Any], SchedulerStats]:
        """Block until every shard is committed or the job has failed; return
        plan-ordered results. Raises the lowest-indexed failed shard's
        original error, or RuntimeError when shards were left unscanned
        (e.g. every worker died)."""
        obs.metrics().gauge("sched.queue_depth").set(len(self._queue))
        threads = [
            threading.Thread(
                target=self._worker_loop, args=(w,), name=f"shard-sched-{w}"
            )
            for w in range(self.n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = self.stats()
        if self._failed:
            raise self._first_error[min(self._failed)]
        missing = [s.index for s in self.plan.shards if s.index not in self._results]
        if missing:
            raise RuntimeError(
                f"scheduler finished with unscanned shards {missing} "
                f"(dead workers: {stats.dead_workers})"
            )
        return [self._results[s.index] for s in self.plan.shards], stats

    def stats(self) -> SchedulerStats:
        return SchedulerStats(
            n_workers=self.n_workers,
            attempts=tuple(
                self._attempts_run[s.index] for s in self.plan.shards
            ),
            retries=self._retries,
            steals=self._steals,
            speculative_launched=self._spec_launched,
            speculative_won=sum(1 for won in self._spec_won.values() if won),
            dead_workers=tuple(self._dead_workers),
        )

    # -- worker side ---------------------------------------------------------

    def _worker_loop(self, w: int) -> None:
        shards_done = 0
        while True:
            if self.faults is not None and self.faults.worker_dead(w, shards_done):
                with self._cond:
                    self._dead_workers.append(w)
                    self._cond.notify_all()
                obs.tracer().instant(
                    "sched.dead_worker", "sched",
                    worker=w, shards_done=shards_done,
                )
                return
            task = self._next_task(w)
            if task is None:
                return
            wait = task.ready_at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            try:
                self._execute(task, w)
            except BaseException as e:  # noqa: BLE001 — scheduler-internal bug
                # an error escaping _execute is a bug in the scheduler
                # itself (run_attempt errors are caught inside): fail the
                # job loudly instead of leaving a half-registered attempt
                # deadlocking the other workers
                self._crash(task, e)
                return
            shards_done += 1

    def _crash(self, task: _Task, err: BaseException) -> None:
        with self._cond:
            runs = self._running.get(task.shard)
            if runs is not None:
                runs[:] = [r for r in runs if r.attempt != task.attempt]
                if not runs:
                    del self._running[task.shard]
            self._first_error.setdefault(task.shard, err)
            self._failed.add(task.shard)
            self._abort = True
            self._cond.notify_all()

    def _next_task(self, w: int) -> _Task | None:
        with self._cond:
            while True:
                if self._abort:
                    # drain-stop: no new work after a permanent shard failure;
                    # in-flight attempts run to completion (their checkpoints
                    # make the eventual resume cheap)
                    self._queue.clear()
                if self._queue:
                    now = time.monotonic()
                    ready = [t for t in self._queue if t.ready_at <= now]
                    if ready:
                        # deterministic preference: lowest shard index first
                        task = min(ready, key=lambda t: t.shard)
                        self._queue.remove(task)
                        obs.metrics().gauge("sched.queue_depth").set(
                            len(self._queue)
                        )
                        if task.shard % self.n_workers != w:
                            self._steals += 1
                            obs.tracer().instant(
                                "sched.steal", "sched",
                                shard=task.shard, worker=w,
                                home=task.shard % self.n_workers,
                            )
                        self._register(task)
                        return task
                    self._cond.wait(
                        timeout=min(t.ready_at for t in self._queue) - now
                    )
                    continue
                if self.speculative and not self._abort:
                    task = self._speculation_candidate()
                    if task is not None:
                        self._register(task)
                        return task
                if any(self._running.values()):
                    self._cond.wait()
                    continue
                return None

    def _register(self, task: _Task) -> None:
        self._running.setdefault(task.shard, []).append(
            _Running(
                attempt=task.attempt,
                speculative=task.speculative,
                cancel=threading.Event(),
                started_at=time.monotonic(),
            )
        )
        self._attempts_run[task.shard] += 1

    def _speculation_candidate(self) -> _Task | None:
        # the longest-running shard with exactly one in-flight attempt and
        # no prior clone: the classic "slowest task near the end of the job"
        candidates = [
            (runs[0].started_at, shard)
            for shard, runs in self._running.items()
            if len(runs) == 1
            and shard not in self._results
            and shard not in self._speculated
        ]
        if not candidates:
            return None
        _, shard = min(candidates)
        self._speculated.add(shard)
        self._spec_launched += 1
        attempt = self._attempt_counter[shard]
        self._attempt_counter[shard] = attempt + 1
        obs.tracer().instant(
            "sched.speculate", "sched", shard=shard, attempt=attempt
        )
        return _Task(shard=shard, attempt=attempt, speculative=True, ready_at=0.0)

    def _execute(self, task: _Task, w: int) -> None:
        shard_obj = self.plan.shards[task.shard]
        run = self._find_running(task)
        span = obs.tracer().span(
            "shard.attempt", "sched",
            shard=task.shard, attempt=task.attempt, worker=w,
            speculative=task.speculative,
        )
        with span:
            try:
                result = self.run_attempt(
                    shard_obj,
                    worker=w,
                    attempt=task.attempt,
                    cancel=run.cancel,
                    speculative=task.speculative,
                )
            except ShardCancelled:
                span.set(outcome="cancelled")
                self._on_cancelled(task)
            except BaseException as e:  # noqa: BLE001 — scheduler owns retry policy
                span.set(outcome="failed")
                self._on_failure(task, e)
            else:
                span.set(outcome="ok")
                self._on_success(task, result)

    def _find_running(self, task: _Task) -> _Running:
        with self._cond:
            for run in self._running[task.shard]:
                if run.attempt == task.attempt:
                    return run
        raise AssertionError(f"attempt {task.attempt} of shard {task.shard} not registered")

    # -- attempt outcomes ----------------------------------------------------

    def _unregister(self, task: _Task) -> list[_Running]:
        """Drop the finished attempt; returns the shard's remaining runs."""
        runs = self._running[task.shard]
        runs[:] = [r for r in runs if r.attempt != task.attempt]
        if not runs:
            del self._running[task.shard]
        return self._running.get(task.shard, [])

    def _maybe_finalize(self, shard: int) -> None:
        """Promote/discard the speculative clone's dir once the shard has no
        in-flight attempts left — called with the lock held."""
        if (
            shard in self._speculated
            and shard not in self._running
            and self.finalize_spec is not None
        ):
            self._speculated.discard(shard)  # exactly-once
            self.finalize_spec(shard, self._spec_won.get(shard, False))

    def _on_success(self, task: _Task, result: Any) -> None:
        with self._cond:
            remaining = self._unregister(task)
            if task.shard not in self._results:
                # first committed attempt wins; rivals get cancelled and
                # their (identical) results discarded
                self._results[task.shard] = result
                self._spec_won[task.shard] = task.speculative
                for rival in remaining:
                    rival.cancel.set()
                    obs.tracer().instant(
                        "sched.cancel", "sched",
                        shard=task.shard, rival_attempt=rival.attempt,
                        winner_attempt=task.attempt,
                    )
            self._maybe_finalize(task.shard)
            self._cond.notify_all()

    def _on_cancelled(self, task: _Task) -> None:
        with self._cond:
            self._unregister(task)
            self._maybe_finalize(task.shard)
            self._cond.notify_all()

    def _on_failure(self, task: _Task, err: BaseException) -> None:
        with self._cond:
            remaining = self._unregister(task)
            if task.shard in self._results:
                # a rival already committed; this late failure is moot
                self._maybe_finalize(task.shard)
                self._cond.notify_all()
                return
            self._failures[task.shard] = self._failures.get(task.shard, 0) + 1
            self._first_error.setdefault(task.shard, err)
            if self._failures[task.shard] > self.max_retries:
                if not remaining:
                    # out of attempts and no rival in flight: the shard is
                    # dead, and with it the job (drain-stop)
                    self._failed.add(task.shard)
                    self._abort = True
                # else: a rival is still running; its outcome decides
            elif not remaining:
                # resume-from-checkpoint retry after capped backoff; any
                # idle worker may pick it up (stealing)
                failures = self._failures[task.shard]
                delay = min(
                    self.backoff_cap, self.backoff_base * (2 ** (failures - 1))
                )
                self._queue.append(
                    _Task(
                        shard=task.shard,
                        attempt=self._attempt_counter[task.shard],
                        speculative=False,
                        ready_at=time.monotonic() + delay,
                    )
                )
                obs.metrics().gauge("sched.queue_depth").set(len(self._queue))
                obs.tracer().instant(
                    "sched.retry", "sched",
                    shard=task.shard, failures=failures, backoff_s=delay,
                    error=type(err).__name__,
                )
                self._attempt_counter[task.shard] += 1
                self._retries += 1
            # else: a rival attempt is in flight — it *is* the retry
            self._maybe_finalize(task.shard)
            self._cond.notify_all()
