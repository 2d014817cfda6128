"""Admission queue + microbatcher: turn a request stream into query blocks.

Claim C1 makes MIREX a natural *service*: per-query scan cost falls as the
query block grows, so the serving layer's job is to hold arriving queries
just long enough to form a big block, then scan once for all of them. Two
triggers close a block:

* **size** — the queue reached the effective block size (``max_batch``
  capped by the bucket ladder, see below); fire immediately, waiting
  longer buys nothing.
* **deadline** — the *oldest* queued request has waited ``max_delay``
  seconds; fire with whatever is queued (tail-latency bound).

Blocks are padded up to bucket sizes (powers of two, at least
``min_bucket``), so a scan sees a few block shapes instead of one per
distinct batch size. Padding rows use a sentinel query (PAD
tokens / zero vectors) whose results are dropped by :func:`unpad_results`.

The bucket ladder is **capped** at ``max_bucket`` (the measured per-query
sweet spot — past it per-query scan cost *rises* again, the @256
amortization cliff), and a backlog larger than the cap is split into
several <= cap blocks instead of padding up a rare giant bucket: the
ladder stays finite (bounded retraces) and every dispatch stays at or
below the sweet spot. Splitting only regroups dispatches — per-request
results are byte-identical whatever the grouping.

Time is injected (every mutating call takes ``now``) so trigger logic is
deterministic under test; the service layer supplies a real clock.

The trigger knobs resolve from the active :class:`repro_torch.tune.TuningConfig`
exactly once, at construction — never on the per-request enqueue or
per-block close paths — and again only on an explicit :meth:`retune`
(the adaptive policy's write surface).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.pipeline import next_pow2
from repro_torch.tune import config as tune_config


def bucket_size(
    n: int, *, min_bucket: int | None = None, max_bucket: int | None = None
) -> int:
    """Padded batch size for ``n`` queries: next power of two, floored at
    ``min_bucket`` and capped at ``max_bucket`` (the ladder cap; a block
    *larger* than the cap — which the batcher never produces — pads to its
    own power of two so padding can never truncate real rows).

    ``None`` knobs resolve from the active tuning config — hot paths
    (the batcher) pass both explicitly, so this per-call resolution only
    happens on direct standalone calls.
    """
    if n < 1:
        raise ValueError("empty batch has no bucket")
    if min_bucket is None or max_bucket is None:
        cfg = tune_config.resolve(None)
        if min_bucket is None:
            min_bucket = cfg.serve_min_bucket
        if max_bucket is None:
            max_bucket = cfg.serve_max_bucket
    size = max(min_bucket, next_pow2(n))
    if max_bucket is not None and n <= max_bucket:
        size = min(size, max_bucket)
    return size


def pad_rows(queries: np.ndarray, n_target: int, pad_value) -> np.ndarray:
    """Pad the leading (batch) dim with sentinel rows up to ``n_target``."""
    n = queries.shape[0]
    if n > n_target:
        raise ValueError(f"batch {n} exceeds target {n_target}")
    if n == n_target:
        return queries
    pad = np.full((n_target - n, *queries.shape[1:]), pad_value, queries.dtype)
    return np.concatenate([queries, pad], axis=0)


def unpad_results(arr, n_real: int):
    """Drop the rows that belong to padding queries."""
    return arr[:n_real]


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One admitted query: tokens ``[L]`` (lexical) or a vector ``[dim]``."""

    rid: int
    query: np.ndarray
    arrival: float


@dataclasses.dataclass(frozen=True)
class QueryBlock:
    """A closed microbatch, padded and ready to scan."""

    queries: np.ndarray  # [n_padded, ...] — rows past n_real are sentinels
    rids: tuple[int, ...]
    n_real: int
    trigger: str  # "size" | "deadline" | "flush"
    closed_at: float
    oldest_arrival: float
    arrivals: tuple[float, ...] = ()  # per-request admission times, rid-aligned

    @property
    def n_padded(self) -> int:
        return self.queries.shape[0]


class Microbatcher:
    """Deadline/size-triggered admission queue for one query family.

    ``pad_value`` fills both the sentinel rows of a short batch and must be
    inert under the scorer (PAD_TOKEN for lexical queries, 0.0 for dense
    vectors — both score every document identically, and their rows are
    discarded before results leave the service).

    The trigger knobs default (``None``) from the active
    :class:`repro_torch.tune.TuningConfig` — ``serve_max_batch`` /
    ``serve_max_delay_s`` / ``serve_min_bucket`` / ``serve_max_bucket`` —
    resolved **once here** (and re-resolved only by :meth:`retune`), never
    per enqueue. The effective per-block size is
    ``min(max_batch, max_bucket)``: asking for a bigger block than the
    bucket-ladder cap would only pad past the sweet spot.
    """

    def __init__(
        self,
        *,
        max_batch: int | None = None,
        max_delay: float | None = None,
        min_bucket: int | None = None,
        max_bucket: int | None = None,
        pad_value=0,
        tuning=None,
    ):
        cfg = tune_config.resolve(tuning)
        self.pad_value = pad_value
        self._pending: list[SearchRequest] = []
        self._apply_knobs(
            max_batch=cfg.serve_max_batch if max_batch is None else max_batch,
            max_delay=cfg.serve_max_delay_s if max_delay is None else max_delay,
            min_bucket=cfg.serve_min_bucket if min_bucket is None else min_bucket,
            max_bucket=cfg.serve_max_bucket if max_bucket is None else max_bucket,
        )

    def _apply_knobs(
        self,
        *,
        max_batch: int,
        max_delay: float,
        min_bucket: int,
        max_bucket: int | None,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_delay < 0:
            raise ValueError("max_delay must be >= 0")
        if min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        if max_bucket is not None and max_bucket < min_bucket:
            raise ValueError(
                f"max_bucket {max_bucket} below min_bucket {min_bucket}"
            )
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        # one block never exceeds the ladder cap: oversize backlogs split
        self._block_cap = (
            max_batch if max_bucket is None else min(max_batch, max_bucket)
        )

    def retune(
        self,
        *,
        max_batch: int | None = None,
        max_delay: float | None = None,
        min_bucket: int | None = None,
        max_bucket: int | object = "keep",
        tuning=None,
    ) -> dict:
        """Rewrite the trigger knobs in place (the adaptive policy's write
        surface; also the only other point where the tuning config is
        consulted). ``None`` keeps the current value except for
        ``max_bucket``, where ``None`` means *uncap* (pass nothing to keep).
        With ``tuning=`` given, unspecified knobs re-resolve from that
        config instead. Returns the effective knob table."""
        if tuning is not None:
            cfg = tune_config.resolve(tuning)
            base = {
                "max_batch": cfg.serve_max_batch,
                "max_delay": cfg.serve_max_delay_s,
                "min_bucket": cfg.serve_min_bucket,
                "max_bucket": cfg.serve_max_bucket,
            }
        else:
            base = {
                "max_batch": self.max_batch,
                "max_delay": self.max_delay,
                "min_bucket": self.min_bucket,
                "max_bucket": self.max_bucket,
            }
        self._apply_knobs(
            max_batch=base["max_batch"] if max_batch is None else max_batch,
            max_delay=base["max_delay"] if max_delay is None else max_delay,
            min_bucket=base["min_bucket"] if min_bucket is None else min_bucket,
            max_bucket=base["max_bucket"] if max_bucket == "keep" else max_bucket,
        )
        return {
            "serve_max_batch": self.max_batch,
            "serve_max_delay_s": self.max_delay,
            "serve_min_bucket": self.min_bucket,
            "serve_max_bucket": self.max_bucket,
        }

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, rid: int, query: np.ndarray, now: float) -> None:
        self._pending.append(SearchRequest(rid=rid, query=np.asarray(query), arrival=now))

    def full(self) -> bool:
        """Whether a whole block is queued (the size trigger)."""
        return len(self._pending) >= self._block_cap

    def _trigger(self, now: float) -> str | None:
        if not self._pending:
            return None
        if self.full():
            return "size"
        # same expression as next_deadline(): an event loop that sleeps to
        # exactly the returned deadline must observe the trigger as fired
        # (now - arrival >= max_delay differs from this in float rounding)
        if now >= self._pending[0].arrival + self.max_delay:
            return "deadline"
        return None

    def ready(self, now: float) -> bool:
        return self._trigger(now) is not None

    def next_deadline(self) -> float | None:
        """Absolute time at which the oldest request forces a flush."""
        if not self._pending:
            return None
        return self._pending[0].arrival + self.max_delay

    def pop_block(self, now: float, *, force: bool = False) -> QueryBlock | None:
        """Close and return the next block, or None if no trigger fired.

        A backlog larger than the block cap yields a <= cap block and
        leaves the remainder queued — the remainder's oldest arrival keeps
        its (already expired) deadline, so the next ``pop_block`` fires
        again immediately: oversize backlogs drain as several sweet-spot
        blocks within one poll loop.
        """
        trigger = "flush" if (force and self._pending) else self._trigger(now)
        if trigger is None:
            return None
        take, self._pending = (
            self._pending[: self._block_cap],
            self._pending[self._block_cap :],
        )
        stacked = np.stack([r.query for r in take], axis=0)
        padded = pad_rows(
            stacked,
            bucket_size(
                len(take), min_bucket=self.min_bucket, max_bucket=self.max_bucket
            ),
            self.pad_value,
        )
        return QueryBlock(
            queries=padded,
            rids=tuple(r.rid for r in take),
            n_real=len(take),
            trigger=trigger,
            closed_at=now,
            oldest_arrival=take[0].arrival,
            arrivals=tuple(r.arrival for r in take),
        )

    def drain(self, now: float) -> list[QueryBlock]:
        """Flush everything pending into (possibly several) blocks."""
        blocks = []
        while self._pending:
            blocks.append(self.pop_block(now, force=True))
        return blocks
