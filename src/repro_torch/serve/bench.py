"""Serve-mode benchmarking: batch-size vs latency/throughput (claim C1).

``sweep_batch_sizes`` replays the same session at several microbatch sizes
and records one curve point per size — per-query latency should *fall* as
the block grows, because the corpus stream through the scan is paid once
per block. ``write_bench_json`` persists the curve (BENCH_serve.json) so
successive PRs can diff serving regressions.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serve.service import RetrievalService
from repro_torch.tune import config as tune_config


def sweep_batch_sizes(
    session,
    make_queries: Callable[[int, int], np.ndarray],
    batch_sizes: Sequence[int],
    *,
    repeats: int = 3,
    warmup: int = 1,
    max_delay: float = 60.0,
) -> dict:
    """Measure one full-block dispatch per batch size; median of repeats.

    ``make_queries(n, seed)`` supplies the query rows. The session's corpus
    stays resident across the whole sweep — only the service/batcher wrapper
    is rebuilt per size, so this measures the steady-state serving path.
    """
    curve = []
    for bs in batch_sizes:
        service = RetrievalService(
            {session.kind: session}, max_batch=bs, max_delay=max_delay
        )
        latencies = []
        for rep in range(warmup + repeats):
            queries = make_queries(bs, rep)
            n_seen = len(service.metrics)
            for row in queries:
                service.submit(row, session.kind)
            # a wave larger than the bucket-ladder cap dispatches as several
            # blocks, which may overlap on the card: the wave's latency runs
            # from its first launch to its last reply
            t0 = time.perf_counter()
            results = service.poll()
            results.update(service.drain())
            wave_s = time.perf_counter() - t0
            assert len(results) == bs, (len(results), bs)
            wave = service.metrics[n_seen:]
            if rep >= warmup:
                latencies.append(wave_s)
        lat = float(np.median(latencies))
        pt = {
            "batch": bs,
            "n_padded": sum(r.n_padded for r in wave),
            "n_blocks": len(wave),
            "latency_ms": lat * 1e3,
            "us_per_query": lat / bs * 1e6,
            "qps": bs / lat,
        }
        # per-point C1 view: batching must never make a query *more* expensive
        pt["amortization_x"] = curve[0]["us_per_query"] / pt["us_per_query"] if curve else 1.0
        curve.append(pt)
    payload = {
        "benchmark": "serve_latency",
        "kind": session.kind,
        "scorer": session.scorer.name,
        "n_docs": session.n_docs,
        "k": session.k,
        "chunk_size": session.chunk_size,
        "batch_sizes": list(batch_sizes),
        "curve": curve,
    }
    if len(curve) >= 2:
        payload["amortization_x"] = curve[0]["us_per_query"] / curve[-1]["us_per_query"]
    return payload


def write_bench_json(payload: dict, path: str = "BENCH_serve.json") -> str:
    """Persist a benchmark payload, stamped with where it was measured.

    Every ``BENCH_*.json`` carries a ``provenance`` block (host, backend,
    torch and CUDA versions, device count, and on a card its name and power
    limit) so perf numbers recorded on different machines or backends are
    comparable — or visibly not. The active
    TuningConfig's hash/source is stamped alongside for the same reason.
    """
    payload = dict(payload)
    payload.setdefault("provenance", obs.provenance())
    payload.setdefault("tuning", tune_config.provenance())
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path
