"""Models-per-pass amortization: the experiment engine's C1-shaped claim.

The paper amortizes one corpus pass over a *query* batch; the experiment
engine amortizes it over a *model grid*. This module measures that curve:
wall-clock of one multi-scorer pass at grid sizes 1, 2, 4, … versus the cost
of running the same models as independent single-scorer passes. Per-model
cost should fall with grid size because the corpus stream and the shared
term-frequency count are paid once per pass (on a card: one launch of the
lexical kernel for the whole grid). Persisted as ``BENCH_experiments.json``.

The port's copy of `repro.experiments.bench`. Each timed pass ends in a
device synchronisation when the corpus lives on a card, so the clock stops
when the kernel has finished, not when it was enqueued; the warm-up passes
take the kernel's first-use build out of the timed ones.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import pipeline, scan
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.serve.bench import write_bench_json


def amortization_curve(
    queries: Any,
    docs: Any,
    scorers: Sequence[Scorer],
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    sizes: Sequence[int] = (1, 2, 4, 8),
    repeats: int = 3,
    warmup: int = 1,
) -> dict:
    """Time one multi-scorer pass at each grid size; median of ``repeats``.

    ``scorers`` must hold at least ``max(sizes)`` variants; size ``m`` scans
    the first ``m``. ``speedup_vs_independent`` at size ``m`` is
    ``m * t(1) / t(m)`` — how much wall-clock the single-pass grid saves
    over ``m`` independent scans of the same corpus. ``queries`` and
    ``docs`` are tensors on one device (a `packing.PackedCorpus` too).
    """
    scorers = tuple(scorers)
    sizes = tuple(sorted(set(sizes)))  # ascending: t(1) must exist before speedups
    if max(sizes) > len(scorers):
        raise ValueError(f"need {max(sizes)} scorer variants, got {len(scorers)}")
    dev = pipeline.leaves(docs)[0].device

    def time_grid(m: int) -> float:
        stack = scorers[:m]
        times = []
        for rep in range(warmup + repeats):
            t0 = time.perf_counter()
            scan.search_local_multi(queries, docs, stack, k=k, chunk_size=chunk_size,
                                    stats=stats)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if rep >= warmup:
                times.append(time.perf_counter() - t0)
        return float(np.median(times))

    curve = []
    t1 = None
    for m in sizes:
        t = time_grid(m)
        if m == 1:
            t1 = t
        point = {
            "models": m,
            "wall_s": t,
            "s_per_model": t / m,
        }
        if t1 is not None:
            point["speedup_vs_independent"] = m * t1 / t
        curve.append(point)

    n_docs = pipeline.leaves(docs)[0].shape[0]
    n_q = pipeline.leaves(queries)[0].shape[0]
    payload = {
        "benchmark": "experiments_amortization",
        "kind": scorers[0].kind,
        "models": [s.name for s in scorers[: max(sizes)]],
        "n_docs": int(n_docs),
        "n_queries": int(n_q),
        "k": k,
        "chunk_size": chunk_size,
        "sizes": list(sizes),
        "curve": curve,
    }
    if len(curve) >= 2 and "s_per_model" in curve[0]:
        payload["amortization_x"] = curve[0]["s_per_model"] / curve[-1]["s_per_model"]
    return payload


__all__ = ["amortization_curve", "write_bench_json"]
