"""Serving driver of the port: thin CLI over the ``repro_torch.serve`` subsystem.

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --n-queries 256
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --slo-p99-ms 50
    # the same on the CPU (the kernels' plain PyTorch versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --device cpu

Search mode runs the paper's system as an online service: queries are
admitted to the :class:`repro_torch.serve.RetrievalService`, microbatched
into query blocks (the amortization lever of claim C1 — bigger blocks,
cheaper per query) and scanned against a resident corpus; per-batch latency
is printed and a batch-size/latency sweep is written to ``BENCH_serve.json``
(with the device it ran on in its provenance). It runs the reduced
``mirex`` config, as the reference's driver does.

Same flags as `repro.launch.serve` plus ``--device`` (default ``cuda``;
without a card and without ``--device cpu`` it raises instead of running
on the CPU). ``--mode decode`` (LM decode) waits for the models slice.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.core import anchors
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.obs import Metrics
from repro_torch.serve import (
    AdaptiveBatchPolicy,
    AdmissionController,
    LexicalSession,
    RetrievalService,
)
from repro_torch.serve.bench import sweep_batch_sizes, write_bench_json


def serve_search(
    n_queries: int,
    n_docs: int = 8192,
    batches: int = 4,
    *,
    max_batch: int | None = None,
    max_delay_ms: float = 5.0,
    scorer: str | None = None,
    sweep_sizes: tuple[int, ...] = (32, 128, 512),
    bench_out: str = "BENCH_serve.json",
    slo_p99_ms: float | None = None,
    queue_limit: int = 256,
    device=None,
):
    dev = resolve_device(device)
    cfg = reduced_config("mirex")
    corpus = synthetic.make_corpus(
        n_docs=n_docs, vocab=cfg.vocab, max_len=cfg.max_doc_len, seed=0, device=dev
    )
    stats = anchors.collection_stats(
        torch.as_tensor(corpus.tokens, device=dev), torch.as_tensor(corpus.lengths, device=dev),
        vocab=cfg.vocab, chunk_size=512,
    )
    session = LexicalSession(
        corpus.tokens,
        corpus.lengths,
        scorer or cfg.scorer,
        k=cfg.k,
        chunk_size=cfg.chunk_size,
        stats=stats,
        device=dev,
    )
    registry = Metrics()  # this service's own histograms (shutdown summary)
    policy = admission = None
    if slo_p99_ms is not None:
        # closed-loop serving: the adaptive policy re-picks the microbatch
        # triggers against the p99 SLO, and admission bounds the queue
        policy = AdaptiveBatchPolicy(slo_p99_s=slo_p99_ms * 1e-3)
        admission = AdmissionController(queue_limit=queue_limit, on_full="shed")
    service = RetrievalService(
        {"lexical": session},
        max_batch=max_batch or n_queries,
        max_delay=max_delay_ms * 1e-3,
        registry=registry,
        admission=admission,
        policy=policy,
    )

    slo_note = f", slo p99 {slo_p99_ms:.0f}ms" if slo_p99_ms is not None else ""
    print(f"== streaming {batches} request waves of {n_queries} queries "
          f"(corpus: {session.n_docs} docs on {dev}, scorer {session.scorer.name}, "
          f"k={session.k}{slo_note}) ==")
    n_shed = 0
    for b in range(batches):
        queries = synthetic.make_queries(corpus, n_queries=n_queries, seed=10 + b)
        n_seen = len(service.metrics)
        rids = []
        for q in queries:
            outcome = service.try_submit(q, "lexical")
            if outcome.admitted:
                rids.append(outcome.rid)
            else:
                n_shed += 1
        results = service.poll()
        results.update(service.drain())  # deadline not yet due -> flush the tail
        assert len(results) == len(rids)
        for blk, rec in enumerate(service.metrics[n_seen:]):
            print(
                f"wave {b} block {blk}: {rec.n_real} queries (padded {rec.n_padded}, "
                f"trigger={rec.trigger}) in {rec.latency_s*1e3:.1f} ms "
                f"({rec.us_per_query:.0f} µs/query)"
            )
        print(f"wave {b}: top-1 of q0 = doc {int(results[rids[0]].ids[0])}")

    # shutdown rollup: full latency/queue-wait/batch-size distributions,
    # not just the per-block means printed above
    summary = registry.summary()
    n_req = summary["counters"].get("serve.requests", 0)
    n_blk = summary["counters"].get("serve.batches", 0)
    print(f"== service summary: {n_req} requests over {n_blk} blocks ==")
    for name, label, scale, unit in (
        ("serve.queue_wait_s", "queue wait", 1e3, "ms"),
        ("serve.latency_s", "scan latency", 1e3, "ms"),
        ("serve.batch_size", "batch size", 1, ""),
    ):
        h = summary["histograms"].get(name)
        if h and h.get("count"):
            print(
                f"  {label:<12} p50={h['p50'] * scale:8.2f}{unit}  "
                f"p95={h['p95'] * scale:8.2f}{unit}  "
                f"p99={h['p99'] * scale:8.2f}{unit}  "
                f"max={h['max'] * scale:8.2f}{unit}"
            )
    if policy is not None:
        d = policy.describe()
        print(
            f"== adaptive policy: {d['adjustments']} adjustments, "
            f"{d['flips']} flips, {d['damped']} damped, "
            f"{d['oscillation_violations']} oscillation violations; "
            f"effective knobs {d['effective']} =="
        )
        print(
            f"   admitted {summary['counters'].get('serve.admitted', 0)}, "
            f"shed {n_shed} (queue_limit {queue_limit})"
        )

    print(f"== C1 sweep: batch sizes {sweep_sizes} ==")
    payload = sweep_batch_sizes(
        session,
        lambda n, seed: synthetic.make_queries(corpus, n_queries=n, seed=100 + seed),
        sweep_sizes,
    )
    for pt in payload["curve"]:
        print(f"  batch {pt['batch']:5d}: {pt['latency_ms']:8.1f} ms "
              f"({pt['us_per_query']:8.0f} µs/query, {pt['qps']:8.1f} qps)")
    path = write_bench_json(payload, bench_out)
    print(f"amortization {payload.get('amortization_x', 1.0):.2f}x "
          f"({sweep_sizes[0]} -> {sweep_sizes[-1]}); wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("search", "decode"), default="search")
    ap.add_argument("--n-queries", type=int, default=256)
    ap.add_argument("--n-docs", type=int, default=8192)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="microbatch size trigger (default: --n-queries)")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="microbatch deadline trigger")
    ap.add_argument("--scorer", default=None, help="lexical scorer (default: config)")
    ap.add_argument("--sweep-sizes", type=int, nargs="+", default=[32, 128, 512],
                    help="batch sizes for the C1 latency sweep")
    ap.add_argument("--bench-out", default="BENCH_serve.json")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="enable the adaptive serving loop: hold request p99 "
                    "to this SLO (closed-loop microbatch control + admission)")
    ap.add_argument("--queue-limit", type=int, default=256,
                    help="admission queue bound when --slo-p99-ms is set")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if args.mode == "decode":
        raise SystemExit("--mode decode (LM decode) waits for the models slice of the port")
    serve_search(
        args.n_queries,
        args.n_docs,
        args.batches,
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        scorer=args.scorer,
        sweep_sizes=tuple(args.sweep_sizes),
        bench_out=args.bench_out,
        slo_p99_ms=args.slo_p99_ms,
        queue_limit=args.queue_limit,
        device=args.device,
    )


if __name__ == "__main__":
    main()
