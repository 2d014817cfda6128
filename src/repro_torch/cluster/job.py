"""Checkpointed sharded scan jobs — MIREX's cluster, kill/resume per shard.

The Hadoop property the paper leans on (any split can be re-executed and
re-reduced without changing the answer) holds at two nested levels:

* **within a shard** — the corpus folds one chunk-aligned *segment* at a
  time; after every segment the stacked ``TopKState`` commits through the
  atomic-rename checkpointer and a ``progress.json`` manifest is rewritten,
  so a killed shard restarts from its last committed segment and replays
  the same per-segment fold (bit-identical resume);
* **across shards** — each shard owns its checkpoint directory and progress
  manifest, and the final `mapreduce.reduce_states` merge is
  value-deterministic, so the merged state (and every run file written from
  it) is byte-identical whatever subset of shards died and resumed, and to
  the one-shard job.

Checkpoints, manifests and fingerprints are the JAX package's
(`repro.cluster.job`) byte for byte, so the port resumes a job the
reference checkpointed.

Failure injection goes through :mod:`repro_torch.cluster.faults`: a seeded
``FaultSchedule`` can crash any shard at any segment (before or after the
checkpoint commit), fail the checkpoint writer mid-commit, slow shards down
(stragglers) and retire scheduler workers. The reliability layer
(:mod:`repro_torch.cluster.scheduler`) turns shards into a work queue:
idle workers steal queued shards, failed shards retry with capped
exponential backoff from their last committed segment (``max_retries``),
and when the queue drains the slowest in-flight shard is speculatively
re-executed from its checkpoint (``speculative=True``),
first-committed-wins.

**The pipelined executor** (``pipelined=True``, the default, as in the
reference) overlaps what the synchronous one serializes, without changing a
byte of any artifact:

* streamed segments — `pipeline.prefetch_segments` stages segment *s+1*
  while segment *s* folds; a corpus already on the device is sliced, a
  host corpus bound for a card is copied on a copy stream of its own, so
  the device holds ``prefetch_depth`` segments of it, not the shard;
* asynchronous checkpoints — each segment's ``save → progress → prune``
  runs on a `checkpoint.AsyncCheckpointer` writer thread in submission
  order, with a drain barrier before any reported kill or completion; the
  job hands it a `checkpoint.snapshot` (a host copy on the fold's stream,
  waited for by the writer), never the live state, and launches the next
  fold at once;
* concurrent shards — ``run_sharded_scan_job`` runs shards through
  :class:`~repro_torch.cluster.scheduler.ShardScheduler`, one worker per
  assigned device (``max_workers`` overrides); on a card each worker's
  attempt runs on a CUDA stream of its own, ordered after the stream that
  made the queries and statistics, and the caller's stream waits for it
  before the plan-ordered reduce.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import obs
from repro_torch.core import pipeline, topk
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.device import canonical_device
from repro_torch.tune import config as tune_config
from repro_torch.tune.config import TuningConfig

from repro_torch.cluster.faults import FaultSchedule, ShardCancelled, WorkerCrash
from repro_torch.cluster.mapreduce import reduce_states, segment_fold
from repro_torch.cluster.plan import ShardPlan, plan_shards
from repro_torch.cluster.scheduler import SchedulerStats, ShardScheduler


@dataclasses.dataclass(frozen=True)
class ScanJobResult:
    state: topk.TopKState  # stacked [n_models, n_q, k]
    segments_run: int  # segments executed by *this* invocation
    segments_total: int
    resumed_from: int  # segment index the run started at (0 = fresh)


@dataclasses.dataclass(frozen=True)
class ShardedScanResult:
    """Merged result of a sharded job + each shard's own job result."""

    state: topk.TopKState  # merged [n_models, n_q, k]
    plan: ShardPlan
    shard_results: tuple[ScanJobResult, ...]
    scheduler: SchedulerStats | None = None  # retry/steal/speculation counters

    @property
    def segments_run(self) -> int:
        return sum(r.segments_run for r in self.shard_results)

    @property
    def segments_total(self) -> int:
        return sum(r.segments_total for r in self.shard_results)

    @property
    def resumed(self) -> bool:
        return any(r.resumed_from for r in self.shard_results)


def _host_bytes(t) -> bytes:
    return (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).tobytes()


def _job_fingerprint(
    queries, docs, scorers, k: int, chunk_size: int, segment_chunks: int,
    doc_id_offset: int, stats,
) -> str:
    """Identity of (data, grid, chunking, segmentation) — guards resume.

    The same hash over the same bytes as the reference: the configuration,
    the full query set, a strided 64-row sample of each corpus leaf, and the
    collection statistics.
    """
    h = hashlib.sha256()
    h.update(
        repr(
            (k, chunk_size, segment_chunks, doc_id_offset, [s.name for s in scorers])
        ).encode()
    )
    for leaf in pipeline.leaves(queries):
        h.update(_host_bytes(leaf))
    for leaf in pipeline.leaves(docs):
        h.update(repr(tuple(leaf.shape)).encode())
        stride = max(1, leaf.shape[0] // 64)
        h.update(_host_bytes(leaf[::stride][:64]))
    if stats is not None:
        for leaf in stats:
            h.update(_host_bytes(leaf))
    return h.hexdigest()[:16]


def _stats_to(stats, device):
    return None if stats is None else type(stats)(*(t.to(device) for t in stats))


# distinguishes "stream ended early" (a scheduler cancel closed the prefetch
# stream) from any real segment when pulling with a default
_STREAM_ENDED = object()


def _chain_first(first, rest):
    """Prepend an already-staged segment to a prefetch stream, keeping the
    stream's close() semantics."""
    try:
        yield first
        yield from rest
    finally:
        rest.close()


def _write_json(path: str, payload: dict) -> None:
    tmp = os.path.join(os.path.dirname(path), ".tmp-" + os.path.basename(path))
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _write_progress(ckpt_dir: str, payload: dict) -> None:
    _write_json(os.path.join(ckpt_dir, "progress.json"), payload)


def read_progress(ckpt_dir: str) -> dict | None:
    path = os.path.join(ckpt_dir, "progress.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def run_scan_job(
    queries: Any,
    docs: Any,
    scorers: Sequence[Scorer],
    *,
    k: int,
    chunk_size: int,
    segment_chunks: int,
    stats: CollectionStats | None = None,
    ckpt_dir: str | None = None,
    resume: bool = True,
    keep_checkpoints: int | None = None,
    fail_at_segment: int | None = None,
    shard: int = 0,
    n_shards: int = 1,
    doc_id_offset: int = 0,
    use_kernel: bool = False,
    device=None,
    pipelined: bool = True,
    prefetch_depth: int | None = None,
    faults: FaultSchedule | None = None,
    attempt: int = 0,
    cancel: threading.Event | None = None,
    tuning: TuningConfig | None = None,
    first_segment: pipeline.Staged | None = None,
    writer: ckpt.AsyncCheckpointer | None = None,
) -> ScanJobResult:
    """Run (or resume) one shard's checkpointed multi-scorer scan — the map
    task of the sharded job, and the whole job when the plan has one shard.

    ``ckpt_dir=None`` is a plain uncheckpointed single pass. The checkpoint
    step number is "segments completed", so ``latest_step`` *is* the resume
    point; ``keep_checkpoints`` bounds disk via ``ckpt.prune``. ``device``
    (default: the queries' device) is where the fold runs and the state
    lives: the kernel on a card, its plain version on the CPU; the queries,
    statistics and a restored state move there. ``use_kernel`` changes
    nothing.

    ``pipelined=True`` (default) runs the overlapped executor: segments
    stream to the device ``prefetch_depth`` ahead of the fold
    (`pipeline.prefetch_segments`) and each commit runs on an async writer
    with a drain barrier (`checkpoint.AsyncCheckpointer`), from a snapshot
    taken on the fold's stream; ``pipelined=False`` is the synchronous
    executor, which moves a corpus not on ``device`` there whole. Both give
    the same states, checkpoints and resume points, byte for byte.

    ``faults`` is the injection schedule consulted at each point of the
    per-segment loop (see :mod:`repro_torch.cluster.faults`); ``attempt``
    is this execution's attempt number for transient-fault matching (0 =
    first try). ``cancel`` is the scheduler's cooperative stop: once set,
    this run raises :class:`ShardCancelled` at the next segment boundary.
    ``fail_at_segment`` is a deprecated alias for one transient post-commit
    crash at that segment.

    ``tuning`` (explicit > active) supplies ``prefetch_depth`` and
    ``keep_checkpoints`` when they are ``None``, and the kernels' blocks.
    ``first_segment`` is segment 0 already staged on ``device`` (the
    cross-shard prefetch), used only on a fresh pipelined start.
    ``writer`` is a caller-owned :class:`checkpoint.AsyncCheckpointer` to
    reuse across shards: the job drains it at the usual barriers but never
    closes it.
    """
    scorers = tuple(scorers)
    del use_kernel
    cfg = tune_config.resolve(tuning)
    if keep_checkpoints is None:
        keep_checkpoints = cfg.keep_checkpoints
    if prefetch_depth is None:
        prefetch_depth = cfg.prefetch_depth
    if fail_at_segment is not None:
        if faults is not None:
            raise ValueError(
                "pass the crash as a FaultSpec in `faults`, not via the "
                "deprecated fail_at_segment kwarg"
            )
        warnings.warn(
            "fail_at_segment is deprecated; use faults=FaultSchedule([...])",
            DeprecationWarning,
            stacklevel=2,
        )
        faults = FaultSchedule.from_legacy(fail_at_segment, shard)
    n_rows = pipeline.leaves(docs)[0].shape[0]
    n_q = pipeline.leaves(queries)[0].shape[0]
    segs = pipeline.segments(n_rows, chunk_size, segment_chunks)
    device = (
        canonical_device(device) if device is not None else pipeline.leaves(queries)[0].device
    )
    queries = pipeline.tree_map(lambda x: x.to(device), queries)
    stats = _stats_to(stats, device)
    if not pipelined:
        # the synchronous executor moves the whole shard up front; the
        # pipelined one streams it segment by segment
        docs = pipeline.tree_map(lambda x: x.to(device), docs)
    state = topk.init(k, (len(scorers), n_q), device=device)

    fingerprint = None
    if ckpt_dir:
        fingerprint = _job_fingerprint(
            queries, docs, scorers, k, chunk_size, segment_chunks, doc_id_offset, stats
        )
    start_seg = 0
    if ckpt_dir and resume:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            prev = read_progress(ckpt_dir)
            if prev is not None and prev.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"checkpoint dir {ckpt_dir!r} belongs to a different job "
                    f"(scorers {prev.get('scorers')}, fingerprint "
                    f"{prev.get('fingerprint')} != {fingerprint}); use a fresh "
                    "dir or resume=False"
                )
            if latest > len(segs):
                raise ValueError(
                    f"checkpoint at segment {latest} but job has {len(segs)} segments"
                )
            state = ckpt.restore(ckpt_dir, latest, state, device=device)
            start_seg = latest
    elif ckpt_dir:
        # fresh start over a dirty dir: drop stale commits
        for s in ckpt.all_steps(ckpt_dir):
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
        stale = os.path.join(ckpt_dir, "progress.json")
        if os.path.exists(stale):
            os.remove(stale)

    fold = segment_fold(scorers, k=k, chunk_size=chunk_size, tuning=cfg)

    def progress(done: int) -> dict:
        return {
            "fingerprint": fingerprint,
            "n_segments": len(segs),
            "chunk_size": chunk_size,
            "segment_chunks": segment_chunks,
            "k": k,
            "scorers": [s.name for s in scorers],
            "shards": {
                str(shard): {
                    "n_shards": n_shards,
                    "doc_id_offset": doc_id_offset,
                    "segments_done": done,
                    "rows_done": segs[done - 1][1] if done else 0,
                    "n_rows": n_rows,
                    "complete": done == len(segs),
                }
            },
        }

    def check_cancel() -> None:
        if cancel is not None and cancel.is_set():
            raise ShardCancelled(f"shard {shard} attempt {attempt} cancelled by the scheduler")

    ran = 0
    tr = obs.tracer()
    met = obs.metrics()
    if pipelined:
        stream_segs = segs[start_seg:]
        if first_segment is not None and start_seg == 0 and stream_segs:
            # cross-shard prefetch: segment 0 was staged while the previous
            # shard folded; the stream starts at segment 1
            rest = pipeline.prefetch_segments(
                docs, stream_segs[1:], device=device, depth=prefetch_depth, cancel=cancel,
            )
            seg_stream = _chain_first(first_segment.take(), rest)
        else:
            seg_stream = pipeline.prefetch_segments(
                docs, stream_segs, device=device, depth=prefetch_depth, cancel=cancel,
            )
    else:
        seg_stream = (pipeline.tree_map(lambda x: x[a:b], docs) for a, b in segs[start_seg:])
    seg_iter = iter(seg_stream)
    writer_owned = writer is None
    if not (pipelined and ckpt_dir):
        writer = None  # the sync and uncheckpointed paths never touch a writer
    elif writer is None:
        writer = ckpt.AsyncCheckpointer()
    shard_span = tr.span(
        "shard.run", "job", shard=shard, attempt=attempt,
        resumed_from=start_seg, n_segments=len(segs),
    )
    with shard_span:
        try:
            for seg_idx in range(start_seg, len(segs)):
                check_cancel()
                # time waiting on the segment stream = the prefetch not
                # keeping up with the fold
                with tr.span("segment.prefetch_wait", "pipeline", shard=shard, segment=seg_idx):
                    seg_docs = next(seg_iter, _STREAM_ENDED)
                if seg_docs is _STREAM_ENDED:
                    break  # the prefetch stream ends early on a cancel
                if faults is not None:
                    faults.maybe_delay(shard, seg_idx, attempt, cancel=cancel)
                    check_cancel()  # a cancelled straggler stops mid-nap
                    if faults.crash_at(shard, seg_idx, attempt, "pre_commit"):
                        # die *before* the commit: work since the last
                        # committed segment is lost and must be re-folded
                        raise WorkerCrash(f"injected failure before segment {seg_idx} commit")
                a, _ = segs[seg_idx]
                t_fold = time.monotonic()
                with tr.span("segment.fold", "job", shard=shard, segment=seg_idx):
                    state = fold(state, queries, seg_docs, stats, doc_id_offset + a)
                met.histogram("job.segment_fold_s").observe(time.monotonic() - t_fold)
                ran += 1
                if ckpt_dir:
                    on_commit = faults.commit_hook(shard, seg_idx, attempt) if faults else None
                    save_kw = {} if on_commit is None else {"on_commit": on_commit}
                    if writer is not None:
                        # commit off the critical path, from a host snapshot
                        # ordered on this stream; submission order keeps the
                        # on-disk sequence the sync path's (an injected
                        # writer error poisons the writer like a real I/O
                        # failure and re-raises at the next drain)
                        with tr.span("segment.commit_submit", "ckpt", shard=shard,
                                     segment=seg_idx):
                            snap = ckpt.snapshot(state)
                            writer.submit(ckpt.save, ckpt_dir, seg_idx + 1, snap, **save_kw)
                            writer.submit(_write_progress, ckpt_dir, progress(seg_idx + 1))
                            writer.submit(ckpt.prune, ckpt_dir, keep_checkpoints)
                    else:
                        with tr.span("segment.commit", "ckpt", shard=shard, segment=seg_idx):
                            ckpt.save(ckpt_dir, seg_idx + 1, state, **save_kw)
                            _write_progress(ckpt_dir, progress(seg_idx + 1))
                            ckpt.prune(ckpt_dir, keep_checkpoints)
                if faults is not None and faults.crash_at(shard, seg_idx, attempt, "post_commit"):
                    # die *after* the commit: the canonical lost-ack kill point
                    if writer is not None:
                        writer.drain()
                    raise WorkerCrash(f"injected failure after segment {seg_idx}")
            check_cancel()  # cooperative stop observed at the segment boundary
            if writer is not None:
                # barrier: every commit durable before we report done; a wait
                # here means the writer is the bottleneck
                with tr.span("ckpt.drain_wait", "ckpt", shard=shard):
                    writer.drain()
        except BaseException:
            if writer is not None:
                # an external writer is only drained (no in-flight commit may
                # outlive this attempt); the in-flight error wins either way
                with contextlib.suppress(BaseException):
                    writer.close() if writer_owned else writer.drain()
                writer = None
            raise
        finally:
            if pipelined:
                seg_stream.close()  # stop the prefetch thread on any exit path
            if writer is not None and writer_owned:
                writer.close()
    if ckpt_dir and start_seg == len(segs):
        _write_progress(ckpt_dir, progress(len(segs)))  # idempotent re-run
    return ScanJobResult(
        state=state, segments_run=ran, segments_total=len(segs), resumed_from=start_seg
    )


def shard_ckpt_dir(ckpt_dir: str, plan: ShardPlan, index: int) -> str:
    """Shard ``index``'s checkpoint directory under the job's ``ckpt_dir``
    (the one-shard plan uses ``ckpt_dir`` itself)."""
    if plan.n_shards == 1:
        return ckpt_dir
    return os.path.join(ckpt_dir, f"shard_{index:04d}")


def read_cluster_manifest(ckpt_dir: str) -> dict | None:
    path = os.path.join(ckpt_dir, "cluster.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def spec_ckpt_dir(primary: str) -> str:
    """A speculative attempt's private checkpoint dir, next to the primary's."""
    return primary + ".spec"


def _seed_spec_dir(primary: str, spec_dir: str) -> None:
    """Seed a speculative clone's checkpoint dir from the primary's last
    committed segment, so the clone re-executes only the shard's tail.

    The primary attempt is still running, so its commits and prunes race
    with this copy; any I/O error falls back to an empty dir — a full
    re-execution, slower but byte-identical.
    """
    shutil.rmtree(spec_dir, ignore_errors=True)
    os.makedirs(spec_dir, exist_ok=True)
    try:
        latest = ckpt.latest_step(primary)
        if latest is not None:
            step = f"step_{latest:08d}"
            shutil.copytree(os.path.join(primary, step), os.path.join(spec_dir, step))
            prog = os.path.join(primary, "progress.json")
            if os.path.exists(prog):
                shutil.copy(prog, os.path.join(spec_dir, "progress.json"))
    except OSError:
        shutil.rmtree(spec_dir, ignore_errors=True)
        os.makedirs(spec_dir, exist_ok=True)


class _ShardStager:
    """Cross-shard prefetch: stage the *next* queued shard's first segment
    while the current one is still folding.

    A worker entering a shard asks the stager to stage the lowest-index
    still-queued shard's first segment onto that shard's home device, on a
    background thread (and, from the host to a card, on a copy stream of
    its own); whichever worker later claims that shard collects it with
    :meth:`take` and hands it to :func:`run_scan_job` as ``first_segment``.
    A staged segment is dropped only when the claim does not match it: the
    shard was stolen onto another device, or claimed before it was staged.
    An error while staging is raised to the claiming attempt.
    """

    def __init__(self, docs, plan: ShardPlan, devices, seg_rows: int):
        self._docs = docs
        self._plan = plan
        self._devices = list(devices)
        self._seg_rows = seg_rows
        self._lock = threading.Lock()
        self._pending = set(range(plan.n_shards))  # not yet claimed by a worker
        self._staged: dict[int, tuple[threading.Thread, list, torch.device]] = {}

    def take(self, index: int, device) -> pipeline.Staged | None:
        """Claim shard ``index``; its staged first segment if it was staged
        onto ``device``, else None."""
        with self._lock:
            self._pending.discard(index)
            entry = self._staged.pop(index, None)
        if entry is None:
            return None
        thread, box, dev = entry
        thread.join()
        if isinstance(box[0], BaseException):
            raise box[0]
        if dev != device:
            return None
        return box[0]

    def stage_next(self) -> None:
        """Start staging the lowest-index queued, un-staged shard (onto its
        round-robin home device). No-op when nothing is queued."""
        with self._lock:
            todo = sorted(i for i in self._pending if i not in self._staged)
            if not todo:
                return
            idx = todo[0]
            shard = self._plan.shards[idx]
            dev = self._devices[idx % len(self._devices)]
            box: list = []

            def _stage():
                try:
                    with obs.tracer().span("prefetch.stage_shard", "pipeline", shard=idx):
                        a = shard.start
                        b = min(shard.stop, a + self._seg_rows)
                        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
                        box.append(pipeline.stage(self._docs, a, b, dev, stream))
                except BaseException as e:  # noqa: BLE001 — raised by take()
                    box.append(e)

            t = threading.Thread(target=_stage, name=f"shard-stage-{idx}", daemon=True)
            # started under the lock: a claim that finds the entry joins a
            # thread that has started
            t.start()
            self._staged[idx] = (t, box, dev)


class _WriterPool:
    """Per-worker `checkpoint.AsyncCheckpointer` reuse for a sharded job.

    The pool hands each worker thread one long-lived writer
    (``threading.local``) that successive `run_scan_job` calls
    drain-but-don't-close. A writer error poisons the writer for good, so a
    failed attempt must :meth:`discard` its worker's writer.
    """

    def __init__(self):
        self._local = threading.local()
        self._all: list = []
        self._lock = threading.Lock()

    def get(self) -> ckpt.AsyncCheckpointer:
        w = getattr(self._local, "writer", None)
        if w is None:
            w = ckpt.AsyncCheckpointer()
            self._local.writer = w
            with self._lock:
                self._all.append(w)
        return w

    def discard(self) -> None:
        """Drop (and close) the calling worker's writer — it may be poisoned."""
        w = getattr(self._local, "writer", None)
        if w is None:
            return
        self._local.writer = None
        with self._lock:
            if w in self._all:
                self._all.remove(w)
        with contextlib.suppress(BaseException):
            w.close()

    def close_all(self) -> None:
        with self._lock:
            writers, self._all = self._all, []
        for w in writers:
            with contextlib.suppress(BaseException):
                w.close()


def run_sharded_scan_job(
    queries: Any,
    docs: Any,
    scorers: Sequence[Scorer],
    *,
    k: int,
    chunk_size: int,
    segment_chunks: int,
    plan: ShardPlan | None = None,
    n_shards: int = 1,
    stats: CollectionStats | None = None,
    ckpt_dir: str | None = None,
    resume: bool = True,
    keep_checkpoints: int | None = None,
    fail_at_segment: int | None = None,
    fail_at_shard: int = 0,
    use_kernel: bool = False,
    devices: Sequence | None = None,
    pipelined: bool = True,
    max_workers: int | None = None,
    faults: FaultSchedule | None = None,
    max_retries: int = 0,
    backoff_base: float | None = None,
    backoff_cap: float | None = None,
    speculative: bool = False,
    tuning: TuningConfig | None = None,
) -> ShardedScanResult:
    """Run (or resume) a full sharded scan job: map every shard, reduce once.

    Pass a :class:`ShardPlan` or just ``n_shards``. Each shard runs
    :func:`run_scan_job` in its own checkpoint directory
    (``<ckpt_dir>/shard_NNNN``; the one-shard plan uses ``ckpt_dir``
    itself), so shards fail and resume independently; completed shards
    replay as no-op restores. ``devices`` spreads shards round-robin (one
    card: ``[torch.device("cuda")]``); without it every shard runs on the
    queries' device. ``docs`` may live on the host: the pipelined executor
    then streams each shard's segments to its device.

    ``pipelined=True`` (default) is the overlapped executor: shards become
    a work queue drained by :class:`~repro_torch.cluster.scheduler.
    ShardScheduler` with one worker per assigned device (``max_workers``
    overrides; two workers on one card run on two CUDA streams). With no
    ``devices`` (or ``max_workers=1``) shards run in plan order on one
    worker, which keeps the synchronous executor's failure ordering.

    ``max_retries`` re-runs a failed shard from its last committed segment
    with capped exponential backoff (``backoff_base``/``backoff_cap``);
    once a shard exhausts its retries the job drain-stops and raises that
    shard's *original* error (the lowest failed shard's).
    ``speculative=True`` clones the slowest in-flight shard when the queue
    drains (first-committed-wins; a winning clone's checkpoint dir is
    promoted over the primary's). ``faults`` injects deterministic failures
    for all of the above; ``fail_at_segment``/``fail_at_shard`` are
    deprecated aliases for one transient post-commit crash. Scheduler
    counters come back on ``ShardedScanResult.scheduler``.

    The merged state is byte-identical for every shard count, both
    executors and any injected schedule. ``tuning`` (explicit > active)
    supplies ``max_workers``, ``keep_checkpoints`` and the backoff when
    they are ``None``, the kernels' blocks, and gates
    ``cross_shard_prefetch`` (stage the next queued shard's first segment
    while the current one folds) and ``writer_reuse`` (one async writer per
    worker, only without fault injection or speculation).
    """
    if fail_at_segment is not None:
        warnings.warn(
            "fail_at_segment/fail_at_shard are deprecated; use "
            "faults=FaultSchedule([FaultSpec(kind='crash', ...)])",
            DeprecationWarning,
            stacklevel=2,
        )
        legacy = FaultSchedule.from_legacy(fail_at_segment, fail_at_shard)
        if faults is None:
            faults = legacy
        else:
            faults.add(legacy.specs[0])

    cfg = tune_config.resolve(tuning)
    if backoff_base is None:
        backoff_base = cfg.backoff_base
    if backoff_cap is None:
        backoff_cap = cfg.backoff_cap
    n_rows = pipeline.leaves(docs)[0].shape[0]
    if plan is None:
        plan = plan_shards(n_rows, n_shards=n_shards, chunk_size=chunk_size)
    if plan.n_docs != n_rows:
        raise ValueError(f"docs have {n_rows} rows but plan covers {plan.n_docs}")
    if plan.chunk_size != chunk_size:
        raise ValueError(
            f"plan chunk_size {plan.chunk_size} != job chunk_size {chunk_size}"
        )

    if ckpt_dir and plan.n_shards > 1:
        manifest = read_cluster_manifest(ckpt_dir)
        if manifest is not None and resume and manifest["plan"] != plan.describe():
            raise ValueError(
                f"checkpoint dir {ckpt_dir!r} holds a different shard plan "
                f"({manifest['plan']['n_shards']} shards over "
                f"{manifest['plan']['n_docs']} docs); use a fresh dir or "
                "resume=False"
            )
        os.makedirs(ckpt_dir, exist_ok=True)
        _write_json(
            os.path.join(ckpt_dir, "cluster.json"),
            {"plan": plan.describe(), "scorers": [s.name for s in scorers], "k": k},
        )

    devices = [canonical_device(d) for d in devices] if devices else None
    workers = 1
    if pipelined:
        workers = max_workers if max_workers else (
            cfg.max_workers or (len(devices) if devices else 1)
        )
        workers = max(1, min(workers, plan.n_shards))
        if devices and len(devices) > workers:
            # only `workers` threads run, each on devices[worker % len]:
            # staging inputs onto devices no worker drives is waste
            devices = devices[:workers]

    # the replicated inputs once per assigned device, on the caller's stream
    staged: dict = {}
    if devices:
        for dev in devices:
            if dev not in staged:
                staged[dev] = (pipeline.tree_map(lambda x, d=dev: x.to(d), queries),
                               _stats_to(stats, dev))
    # each worker stream waits for the caller's stream on its device (where
    # the queries and statistics were made), and the caller's waits for it
    home = {d for d in staged} if devices else {pipeline.leaves(queries)[0].device}
    parents = {d: torch.cuda.current_stream(d) for d in home if d.type == "cuda"}

    stager = None
    if pipelined and cfg.cross_shard_prefetch and devices and plan.n_shards > 1:
        stager = _ShardStager(docs, plan, devices, seg_rows=chunk_size * segment_chunks)

    writer_pool = None
    if pipelined and ckpt_dir and cfg.writer_reuse and faults is None and not speculative:
        writer_pool = _WriterPool()

    def attempt_on(shard, device, q, st, attempt, cancel, speculative) -> ScanJobResult:
        sdir = shard_ckpt_dir(ckpt_dir, plan, shard.index) if ckpt_dir else None
        if speculative and sdir is not None:
            primary, sdir = sdir, spec_ckpt_dir(sdir)
            _seed_spec_dir(primary, sdir)
        first_seg = None
        if stager is not None and not speculative:
            first_seg = stager.take(shard.index, device)
            stager.stage_next()  # overlap the *next* shard with this fold
        ext_writer = writer_pool.get() if writer_pool is not None else None
        try:
            return run_scan_job(
                q,
                shard.take(docs),
                scorers,
                k=k,
                chunk_size=chunk_size,
                segment_chunks=segment_chunks,
                stats=st,
                ckpt_dir=sdir,
                # retries and speculative clones always resume: the last
                # committed segment is the unit of re-execution
                resume=resume or attempt > 0 or speculative,
                keep_checkpoints=keep_checkpoints,
                shard=shard.index,
                n_shards=plan.n_shards,
                doc_id_offset=shard.doc_id_offset,
                device=device,
                pipelined=pipelined,
                faults=faults,
                attempt=attempt,
                cancel=cancel,
                tuning=cfg,
                first_segment=first_seg,
                writer=ext_writer,
            )
        except BaseException:
            if writer_pool is not None:
                writer_pool.discard()  # a failed attempt may have poisoned it
            raise

    def run_attempt(
        shard, *, worker=None, attempt=0, cancel=None, speculative=False
    ) -> ScanJobResult:
        q, st = queries, stats
        device = pipeline.leaves(queries)[0].device
        if devices:
            # the executing worker's device, not the shard's round-robin
            # home: a stolen shard folds wherever it was picked up
            owner = shard.index if worker is None else worker
            device = devices[owner % len(devices)]
            q, st = staged[device]
        if not (pipelined and device.type == "cuda"):
            return attempt_on(shard, device, q, st, attempt, cancel, speculative)
        parent = parents[device]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(parent)
        with torch.cuda.stream(stream):
            result = attempt_on(shard, device, q, st, attempt, cancel, speculative)
        parent.wait_stream(stream)
        for t in result.state:
            t.record_stream(parent)
        return result

    def finalize_spec(index: int, won: bool) -> None:
        # both attempts have stopped (scheduler invariant): promote the
        # winning clone's lineage over the primary's, or drop the clone's
        if not ckpt_dir:
            return
        primary = shard_ckpt_dir(ckpt_dir, plan, index)
        sdir = spec_ckpt_dir(primary)
        if won and os.path.exists(sdir):
            ckpt.replace_dir(sdir, primary)
        else:
            shutil.rmtree(sdir, ignore_errors=True)

    if not pipelined:
        # the synchronous executor: plan order, one attempt in flight,
        # retries inline (no threads, no stealing, no speculation)
        results: list[ScanJobResult] = []
        attempts: list[int] = []
        retries = 0
        for s in plan.shards:
            failures = 0
            while True:
                try:
                    results.append(run_attempt(s, attempt=failures))
                    attempts.append(failures + 1)
                    break
                except ShardCancelled:
                    raise  # no scheduler to cancel us — never expected
                except BaseException:
                    failures += 1
                    if failures > max_retries:
                        raise
                    retries += 1
                    time.sleep(min(backoff_cap, backoff_base * (2 ** (failures - 1))))
        stats_out = SchedulerStats(
            n_workers=1,
            attempts=tuple(attempts),
            retries=retries,
            steals=0,
            speculative_launched=0,
            speculative_won=0,
            dead_workers=(),
        )
    else:
        # the reliability layer: results (and any failure) come back in plan
        # order however shards interleave
        sched = ShardScheduler(
            plan,
            run_attempt,
            n_workers=workers,
            max_retries=max_retries,
            backoff_base=backoff_base,
            backoff_cap=backoff_cap,
            speculative=speculative,
            faults=faults,
            finalize_spec=finalize_spec if speculative else None,
        )
        try:
            results, stats_out = sched.run()
        finally:
            if writer_pool is not None:
                writer_pool.close_all()

    states = [r.state for r in results]
    if devices:
        # reduce on one device: k-bounded payloads, the paper's shuffle
        states = [topk.TopKState(*(t.to(devices[0]) for t in st)) for st in states]
    merged = reduce_states(states)
    return ShardedScanResult(
        state=merged, plan=plan, shard_results=tuple(results), scheduler=stats_out
    )
