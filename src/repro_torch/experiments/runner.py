"""Experiment orchestration: prepare → scan job → run files → eval report.

One call runs the whole MIREX experiment lifecycle for a declared grid:

  1. **prepare** — deterministic synthetic collection (byte-identical to the
     JAX package's for the same seed) + collection-statistics job + queries
     + graded qrels;
  2. **scan** — one resumable multi-scorer corpus pass
     (`cluster.run_sharded_scan_job`, pipelined by default): every grid
     point shares the corpus stream, and on a CUDA device every segment
     goes through the CUDA lexical-scan kernel;
  3. **report** — per-model TREC run files, the `repro_torch.eval` report
     card (MAP / P@k / NDCG / MRR / recall), and paired-randomization
     significance of every variant against the declared baseline.

Everything is keyed by ``seed``, so a re-run (or a kill/resume) regenerates
byte-identical artifacts. ``device`` defaults to ``cuda``; without a card
the runner raises rather than run on the CPU unasked.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import obs, tune
from repro_torch.cluster import FaultSchedule, plan_shards, run_sharded_scan_job
from repro_torch.core import anchors, packing, topk
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.eval import evaluate_run, paired_randomization_test, trec
from repro_torch.experiments.grid import ExperimentSpec
from repro_torch.tune import TuningConfig


@dataclasses.dataclass(frozen=True)
class Collection:
    corpus: synthetic.Corpus
    stats: Any  # CollectionStats of tensors on the run's device
    queries: np.ndarray
    qrels: np.ndarray  # graded [n_q, n_docs] int8


def prepare_collection(spec: ExperimentSpec, *, seed: int = 0, device=None) -> Collection:
    """The prepare stage: corpus, stats job, queries, graded qrels."""
    dev = resolve_device(device)
    corpus = synthetic.make_corpus(
        n_docs=spec.n_docs, vocab=spec.vocab, max_len=spec.max_doc_len, seed=seed,
        device=dev,
    )
    stats = anchors.collection_stats(
        torch.as_tensor(corpus.tokens, device=dev),
        torch.as_tensor(corpus.lengths, device=dev),
        vocab=spec.vocab,
        chunk_size=min(spec.chunk_size, spec.n_docs),
    )
    queries = synthetic.make_queries(corpus, n_queries=spec.n_queries, seed=seed + 1)
    qrels = synthetic.make_graded_qrels(
        corpus, queries, per_query=25, seed=seed + 2, device=dev
    )
    return Collection(corpus=corpus, stats=stats, queries=queries, qrels=qrels)


def run_filename(variant: str) -> str:
    """Filesystem-safe run-file name for a scorer variant."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", variant).strip("_") + ".run"


def write_run_files(
    out_dir: str, scorers, state: topk.TopKState, *, tag_prefix: str
) -> dict[str, str]:
    """One TREC run file per model from the stacked job state."""
    os.makedirs(out_dir, exist_ok=True)
    valid = topk.valid_mask(state).cpu().numpy()
    ids = state.ids.cpu().numpy()
    scores = state.scores.cpu().numpy()
    paths = {}
    for m, s in enumerate(scorers):
        path = os.path.join(out_dir, run_filename(s.name))
        trec.write_run(
            path, ids[m], scores[m], run_tag=f"{tag_prefix}/{s.name}", valid=valid[m]
        )
        paths[s.name] = path
    return paths


def run_experiment(
    spec: ExperimentSpec,
    *,
    out_dir: str,
    seed: int = 0,
    resume: bool = True,
    fail_at_segment: int | None = None,
    fail_at_shard: int = 0,
    collection: Collection | None = None,
    pipelined: bool = True,
    max_workers: int | None = None,
    faults: Any | None = None,
    max_retries: int = 0,
    speculative: bool = False,
    trace_out: str | None = None,
    tuning: TuningConfig | None = None,
    tune_lookup: bool = False,
    tune_cache: str | None = None,
    device=None,
) -> dict:
    """Execute the full lifecycle; returns (and writes) the report dict.

    Artifacts under ``out_dir``: ``runs/<variant>.run``, ``qrels.txt``,
    ``ckpt/`` (segment checkpoints + progress manifests; per-shard subdirs
    when ``spec.n_shards > 1``), ``report.json``. Run files are byte-
    identical at every shard count and across a crash and resume.

    ``device`` (default ``cuda``) is where the corpus lives and the scan
    runs; with ``spec.n_shards > 1`` the shards run on that one device.
    ``pipelined`` (default) is the overlapped executor (streamed segments,
    asynchronous checkpoints, concurrent shards; byte-identical artifacts
    either way) and ``max_workers`` caps its shard workers (default one per
    device; two on one card run on two CUDA streams). ``faults`` (a
    `repro_torch.cluster.FaultSchedule`), ``max_retries`` and
    ``speculative`` drive the reliability layer; the report's ``job``
    section records what the scheduler did. ``fail_at_segment``/
    ``fail_at_shard`` are the deprecated single-crash alias. ``trace_out``
    installs a fresh tracer + metrics for the run and writes the Chrome
    trace there. A ``tuning`` whose ``token_pack`` is not ``"none"`` packs
    the corpus on the host before the scan (`packing.pack_corpus`) when
    every scorer is lexical; the run files are the unpacked run's, byte for
    byte. ``tune_lookup``/``tune_cache`` (the autotune winner cache) wait
    for the autotune slice and raise ``NotImplementedError``.
    """
    dev = resolve_device(device)
    if tune_lookup or tune_cache is not None:
        raise NotImplementedError(
            "the autotune winner cache (--tune) waits for the autotune slice of the port"
        )
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

    tuning_source = "explicit" if tuning is not None else "default"
    prev_obs = None
    if trace_out is not None:
        prev_obs = obs.install(obs.Tracer(), obs.Metrics())
    try:
        with tune.use(tuning, source=tuning_source):
            return _run_experiment_traced(
                spec,
                out_dir=out_dir,
                seed=seed,
                resume=resume,
                collection=collection,
                pipelined=pipelined,
                max_workers=max_workers,
                faults=faults,
                max_retries=max_retries,
                speculative=speculative,
                trace_out=trace_out,
                tuning=tuning,
                tuning_source=tuning_source,
                device=dev,
            )
    finally:
        if prev_obs is not None:
            obs.install(*prev_obs)


def _run_experiment_traced(
    spec: ExperimentSpec,
    *,
    out_dir: str,
    seed: int,
    resume: bool,
    collection: Collection | None,
    pipelined: bool,
    max_workers: int | None,
    faults: Any | None,
    max_retries: int,
    speculative: bool,
    trace_out: str | None,
    tuning: TuningConfig | None,
    tuning_source: str,
    device: torch.device,
) -> dict:
    """The lifecycle body, running under whatever instruments are installed."""
    tr = obs.tracer()
    met = obs.metrics()
    cfg = tune.resolve(tuning)
    # clamp eval cutoffs to the run depth up front
    if spec.k < max(spec.eval_ks):
        ks = tuple(c for c in spec.eval_ks if c <= spec.k) or (spec.k,)
        spec = dataclasses.replace(spec, eval_ks=ks)
    with tr.span("experiment.prepare", "experiment", experiment=spec.name, seed=seed):
        coll = (
            collection if collection is not None
            else prepare_collection(spec, seed=seed, device=device)
        )
    scorers = spec.scorers()
    stats = type(coll.stats)(*(t.to(device) for t in coll.stats))
    # pack on the producer: token segments shrink to the tuned width here,
    # before they reach the card, and the scan decodes exactly — run files
    # stay byte-identical to the unpacked run (the pack contract)
    pack_resolved = "none"
    docs = None
    if cfg.token_pack != "none" and all(s.kind == "lexical" for s in scorers):
        packed = packing.pack_corpus(
            coll.corpus.tokens, coll.corpus.lengths, vocab=spec.vocab, mode=cfg.token_pack,
        )
        if isinstance(packed, packing.PackedCorpus):
            pack_resolved = packed.spec.mode
            docs = packed.to(device)
    if docs is None:
        docs = (
            torch.as_tensor(coll.corpus.tokens, device=device),
            torch.as_tensor(coll.corpus.lengths, device=device),
        )

    # the tuned chunk replaces the spec's for the scan fold only, and only
    # when it divides every shard (a knob may be ignored, never fail a job)
    chunk = spec.chunk_size
    if cfg.chunk_size is not None:
        per_shard = spec.n_docs // max(1, spec.n_shards)
        if spec.n_docs % max(1, spec.n_shards) == 0 and per_shard % cfg.chunk_size == 0:
            chunk = cfg.chunk_size

    # shards run on the run's one device (one card: one worker unless
    # max_workers asks for more)
    plan = plan_shards(spec.n_docs, n_shards=spec.n_shards, chunk_size=chunk)
    devices = [device] if spec.n_shards > 1 else None
    with tr.span("experiment.scan", "experiment", n_shards=plan.n_shards, pipelined=pipelined):
        job = run_sharded_scan_job(
            torch.as_tensor(coll.queries, device=device),
            docs,
            scorers,
            k=spec.k,
            chunk_size=chunk,
            segment_chunks=spec.segment_chunks,
            plan=plan,
            stats=stats,
            ckpt_dir=os.path.join(out_dir, "ckpt"),
            resume=resume,
            devices=devices,
            pipelined=pipelined,
            max_workers=max_workers,
            faults=faults,
            max_retries=max_retries,
            speculative=speculative,
            tuning=cfg,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tr.span("experiment.run_files", "experiment"):
        run_paths = write_run_files(
            os.path.join(out_dir, "runs"), scorers, job.state, tag_prefix=spec.name
        )
        trec.write_qrels(os.path.join(out_dir, "qrels.txt"), coll.qrels)

    with tr.span("experiment.eval", "experiment"):
        reports = {}
        per_query_ap = {}
        ids = job.state.ids.cpu().numpy()
        for m, s in enumerate(scorers):
            rep = evaluate_run(ids[m], coll.qrels, ks=spec.eval_ks)
            reports[s.name] = rep["aggregate"]
            per_query_ap[s.name] = rep["per_query"]["ap"]

        significance = {}
        baseline = spec.baseline if spec.baseline in per_query_ap else scorers[0].name
        for name, ap in per_query_ap.items():
            if name == baseline:
                continue
            res = paired_randomization_test(ap, per_query_ap[baseline], seed=seed)
            significance[name] = {
                "vs": baseline,
                "metric": "ap",
                "diff": res.diff,
                "p_value": res.p_value,
            }

    obs_block = None
    if trace_out is not None:
        # the trace lives *outside* runs/ so artifact byte-identity checks
        # diff the run dirs untouched
        trace_dir = os.path.dirname(trace_out)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
        jsonl_path = os.path.splitext(trace_out)[0] + ".jsonl"
        obs.export.write_chrome_trace(trace_out, tr, metrics=met)
        obs.export.write_jsonl(jsonl_path, tr)
        obs_block = {
            "trace": trace_out,
            "events_jsonl": jsonl_path,
            "n_events": len(tr),
            "metrics": met.summary(),
            "phases": obs.export.phase_rollup(tr),
        }

    report = {
        "experiment": spec.name,
        "seed": seed,
        "n_docs": spec.n_docs,
        "n_queries": spec.n_queries,
        "k": spec.k,
        "device": str(device),
        "models": [s.name for s in scorers],
        "job": {
            "n_shards": job.plan.n_shards,
            "pipelined": pipelined,
            "segments_total": job.segments_total,
            "segments_run": job.segments_run,
            "resumed_from": max(r.resumed_from for r in job.shard_results),
            "max_retries": max_retries,
            "speculative": speculative,
            "scheduler": job.scheduler.describe() if job.scheduler else None,
            "faults_fired": faults.fired if faults is not None else [],
            "tuning": {
                "config_hash": cfg.config_hash(),
                "source": tuning_source,
                "cache_hit": False,
                "overrides": cfg.overrides(),
                "chunk_size": chunk,
                "token_pack": cfg.token_pack,
                "pack_resolved": pack_resolved,
            },
            "obs": obs_block,
            "shards": [
                {
                    "segments_total": r.segments_total,
                    "segments_run": r.segments_run,
                    "resumed_from": r.resumed_from,
                }
                for r in job.shard_results
            ],
        },
        "runs": run_paths,
        "metrics": reports,
        "baseline": baseline,
        "significance": significance,
    }
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    return report
