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

This slice runs the synchronous executor (``pipelined=False``): shards in
plan order on one device. The pipelined executor (segment prefetch, async
commits, concurrent shards), retries and speculation wait for the executor
slice and raise ``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import obs
from repro_torch.core import pipeline, topk
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.tune import config as tune_config
from repro_torch.tune.config import TuningConfig

from repro_torch.cluster.faults import _EXECUTOR_SLICE, FaultSchedule, WorkerCrash
from repro_torch.cluster.mapreduce import reduce_states, segment_fold
from repro_torch.cluster.plan import ShardPlan, plan_shards


@dataclasses.dataclass(frozen=True)
class ScanJobResult:
    state: topk.TopKState  # stacked [n_models, n_q, k]
    segments_run: int  # segments executed by *this* invocation
    segments_total: int
    resumed_from: int  # segment index the run started at (0 = fresh)


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """What the executor did — the reference's report block
    (`repro.cluster.scheduler.SchedulerStats`), filled by the synchronous
    executor: one worker, one attempt per shard."""

    n_workers: int
    attempts: tuple[int, ...]
    retries: int
    steals: int
    speculative_launched: int
    speculative_won: int
    dead_workers: tuple[int, ...]

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["attempts"] = list(self.attempts)
        d["dead_workers"] = list(self.dead_workers)
        return d


@dataclasses.dataclass(frozen=True)
class ShardedScanResult:
    """Merged result of a sharded job + each shard's own job result."""

    state: topk.TopKState  # merged [n_models, n_q, k]
    plan: ShardPlan
    shard_results: tuple[ScanJobResult, ...]
    scheduler: SchedulerStats | None = None

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


def _refuse_pipelined(pipelined: bool) -> None:
    if pipelined:
        raise NotImplementedError(
            f"pipelined=True waits for {_EXECUTOR_SLICE}; pass pipelined=False"
        )


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
    pipelined: bool = False,
    faults: FaultSchedule | None = None,
    tuning: TuningConfig | None = None,
) -> ScanJobResult:
    """Run (or resume) one shard's checkpointed multi-scorer scan — the map
    task of the sharded job, and the whole job when the plan has one shard.

    ``ckpt_dir=None`` is a plain uncheckpointed single pass. The checkpoint
    step number is "segments completed", so ``latest_step`` *is* the resume
    point; ``keep_checkpoints`` bounds disk via ``ckpt.prune``. The fold runs
    on the device the tensors live on (the kernel on CUDA, its plain version
    on the CPU); ``use_kernel`` changes nothing.

    ``faults`` is the crash schedule consulted around each segment's commit
    (see :mod:`repro_torch.cluster.faults`); ``fail_at_segment`` is its
    deprecated alias for one transient post-commit crash.
    """
    _refuse_pipelined(pipelined)
    scorers = tuple(scorers)
    cfg = tune_config.resolve(tuning)
    if keep_checkpoints is None:
        keep_checkpoints = cfg.keep_checkpoints
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
    device = pipeline.leaves(queries)[0].device
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

    ran = 0
    tr = obs.tracer()
    met = obs.metrics()
    with tr.span(
        "shard.run", "job", shard=shard,
        resumed_from=start_seg, n_segments=len(segs),
    ):
        for seg_idx in range(start_seg, len(segs)):
            a, b = segs[seg_idx]
            seg_docs = pipeline.tree_map(lambda x: x[a:b], docs)
            if faults is not None and faults.crash_at(shard, seg_idx, "pre_commit"):
                raise WorkerCrash(f"injected failure before segment {seg_idx} commit")
            t_fold = time.monotonic()
            with tr.span("segment.fold", "job", shard=shard, segment=seg_idx):
                state = fold(state, queries, seg_docs, stats, doc_id_offset + a)
            met.histogram("job.segment_fold_s").observe(time.monotonic() - t_fold)
            ran += 1
            if ckpt_dir:
                with tr.span("segment.commit", "ckpt", shard=shard, segment=seg_idx):
                    ckpt.save(ckpt_dir, seg_idx + 1, state)
                    _write_progress(ckpt_dir, progress(seg_idx + 1))
                    ckpt.prune(ckpt_dir, keep_checkpoints)
            if faults is not None and faults.crash_at(shard, seg_idx, "post_commit"):
                # die *after* the commit: the canonical lost-ack kill point
                raise WorkerCrash(f"injected failure after segment {seg_idx}")
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
    pipelined: bool = False,
    faults: FaultSchedule | None = None,
    max_retries: int = 0,
    speculative: bool = False,
    tuning: TuningConfig | None = None,
) -> ShardedScanResult:
    """Run (or resume) a full sharded scan job: map every shard, reduce once.

    Pass a :class:`ShardPlan` or just ``n_shards``. Each shard runs
    :func:`run_scan_job` in its own checkpoint directory
    (``<ckpt_dir>/shard_NNNN``; the one-shard plan uses ``ckpt_dir`` itself),
    in plan order on the device its tensors live on; completed shards replay
    as no-op restores. The merged state is byte-identical at every shard
    count. ``max_retries``, ``speculative`` and ``pipelined=True`` wait for
    the executor slice.
    """
    _refuse_pipelined(pipelined)
    if max_retries:
        raise NotImplementedError(f"max_retries waits for {_EXECUTOR_SLICE}")
    if speculative:
        raise NotImplementedError(f"speculative execution waits for {_EXECUTOR_SLICE}")
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

    results = []
    for shard in plan.shards:
        results.append(
            run_scan_job(
                queries,
                shard.take(docs),
                scorers,
                k=k,
                chunk_size=chunk_size,
                segment_chunks=segment_chunks,
                stats=stats,
                ckpt_dir=shard_ckpt_dir(ckpt_dir, plan, shard.index) if ckpt_dir else None,
                resume=resume,
                keep_checkpoints=keep_checkpoints,
                shard=shard.index,
                n_shards=plan.n_shards,
                doc_id_offset=shard.doc_id_offset,
                faults=faults,
                tuning=cfg,
            )
        )
    stats_out = SchedulerStats(
        n_workers=1,
        attempts=tuple(1 for _ in results),
        retries=0,
        steals=0,
        speculative_launched=0,
        speculative_won=0,
        dead_workers=(),
    )
    merged = reduce_states([r.state for r in results])
    return ShardedScanResult(
        state=merged, plan=plan, shard_results=tuple(results), scheduler=stats_out
    )
