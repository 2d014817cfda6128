"""Deterministic crash injection for sharded scan jobs.

This slice ports the crash kind of `repro.cluster.faults`: a
:class:`FaultSpec` ``kind="crash"`` makes the worker "die" on a shard,
either *before* a segment's checkpoint commits (work since the last commit
is lost) or *after* it (the canonical lost-ack kill: the commit is durable
but never acknowledged), raising :class:`WorkerCrash`. The deprecated
``fail_at_segment``/``fail_at_shard`` arguments compile to one transient
post-commit crash (:meth:`FaultSchedule.from_legacy`).

The synchronous executor runs each shard once, so a crash matches on
``(shard, segment, phase)`` and always fires there. Per-attempt matching
(``attempts=``), writer errors, stragglers, dead workers and seeded chaos
schedules wait for the executor slice, which has retries to need them;
asking for one raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable, Sequence

from repro_torch import obs

KINDS = ("crash", "writer_error", "straggler", "dead_worker")
PORTED_KINDS = ("crash",)
PHASES = ("pre_commit", "post_commit")
_EXECUTOR_SLICE = "the executor slice of the port (pipelined executor, scheduler and faults)"


class InjectedFault(RuntimeError):
    """Base of all injected failures."""


class WorkerCrash(InjectedFault):
    """An injected worker death ("injected failure ..." messages)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault. ``shard=None`` means "any"."""

    kind: str
    shard: int | None = None
    segment: int | None = None
    phase: str = "post_commit"  # pre_commit | post_commit

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.kind not in PORTED_KINDS:
            raise NotImplementedError(f"{self.kind} faults wait for {_EXECUTOR_SLICE}")
        if self.phase not in PHASES:
            raise ValueError(f"unknown crash phase {self.phase!r}; one of {PHASES}")
        if self.segment is None:
            raise ValueError(f"{self.kind} fault needs an explicit segment")

    def matches(self, shard: int, segment: int) -> bool:
        return (self.shard is None or self.shard == shard) and self.segment == segment

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def parse_fault(spec: str) -> FaultSpec:
    """Parse the CLI syntax ``crash:shard=1,segment=0,phase=pre_commit``."""
    kind, _, params = spec.partition(":")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} in {spec!r}; one of {KINDS}")
    kwargs: dict = {}
    if params:
        for item in params.split(","):
            key, sep, val = item.partition("=")
            if not sep or not val:
                raise ValueError(f"malformed fault param {item!r} in {spec!r}")
            if key in ("shard", "segment"):
                kwargs[key] = int(val)
            elif key == "attempts":
                raise NotImplementedError(f"per-attempt faults wait for {_EXECUTOR_SLICE}")
            elif key == "phase":
                kwargs[key] = val
            else:
                raise ValueError(f"unknown fault param {key!r} in {spec!r}")
    return FaultSpec(kind=kind, **kwargs)


class FaultSchedule:
    """A set of :class:`FaultSpec` s plus a thread-safe log of fired faults."""

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: tuple[FaultSpec, ...] = tuple(specs)
        self._lock = threading.Lock()
        self._fired: list[dict] = []

    def add(self, spec: FaultSpec) -> "FaultSchedule":
        """Append a spec in place (keeps the caller's ``fired`` log live)."""
        self.specs = self.specs + (spec,)
        return self

    @classmethod
    def from_legacy(cls, fail_at_segment: int, fail_at_shard: int) -> "FaultSchedule":
        """The deprecated ``fail_at_segment``/``fail_at_shard`` arguments:
        one post-commit crash on one shard."""
        return cls(
            [FaultSpec(kind="crash", shard=fail_at_shard, segment=fail_at_segment,
                       phase="post_commit")]
        )

    def _record(self, spec: FaultSpec, **ctx) -> None:
        with self._lock:
            self._fired.append({"kind": spec.kind, **ctx})
        obs.tracer().instant(f"fault.{spec.kind}", "fault", **ctx)

    @property
    def fired(self) -> list[dict]:
        """Snapshot of every fault that actually fired."""
        with self._lock:
            return list(self._fired)

    def count_fired(self, kind: str) -> int:
        with self._lock:
            return sum(1 for e in self._fired if e["kind"] == kind)

    def describe(self) -> list[dict]:
        return [s.describe() for s in self.specs]

    def crash_at(self, shard: int, segment: int, phase: str) -> FaultSpec | None:
        """The matching crash spec for this ``phase``, recorded — or None."""
        for spec in self.specs:
            if spec.kind == "crash" and spec.phase == phase and spec.matches(shard, segment):
                self._record(spec, shard=shard, segment=segment, phase=phase)
                return spec
        return None


def build_schedule(specs: Sequence[str]) -> FaultSchedule:
    """Parse a list of CLI fault strings into one schedule."""
    return FaultSchedule([parse_fault(s) for s in specs])
