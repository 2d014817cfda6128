"""The scan job as a tuning target: its knob space, its measure, its record.

The port's counterpart of the scan target of the reference's autotune
harness (``benchmarks/autotune.py``): a `KnobSpace` over the knobs the
port's scan job reads — the fold's ``chunk_size``, the pipelined
executor's ``prefetch_depth`` and ``token_pack`` — bound to
`cluster.run_sharded_scan_job` as `experiments.runner` runs it (the corpus
and statistics on the run's device, the tuned chunk in place of the
declared one), with no checkpoint directory: it measures the scan, not the
writer.

Two contracts hold on every trial, not only the winner:

* **byte identity** — a trial's merged top-k state must be the bytes of a
  default-config run made once up front (tuning changes speed, never
  bytes); a trial that differs fails, and :func:`tune_target` then fails.
* **default in the tournament** — the space's base is candidate #0, so the
  recorded winner is at least the default within the session.

A trial's clock stops after a device synchronisation on a card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.cluster import run_sharded_scan_job
from repro_torch.core import packing
from repro_torch.device import resolve_device
from repro_torch.tune import scan_shape_sig_for
from repro_torch.tune.cache import TuneCache, backend_sig
from repro_torch.tune.config import TuningConfig
from repro_torch.tune.search import Knob, KnobSpace, search

TOKEN_PACKS = ("none", "auto", "bitpack")


@dataclasses.dataclass(frozen=True)
class Target:
    """One tunable workload: a knob space bound to a measurement."""

    name: str
    space: KnobSpace
    shape: str
    backend: str
    measure: Callable[[TuningConfig], float]  # figure of merit, higher is better
    run: Callable[[TuningConfig], object]  # one job under a config -> its state
    oracle: bytes  # the default config's state bytes
    meta: dict


def scan_space(spec, *, chunk_values: Sequence[int], prefetch_values: Sequence[int],
               token_packs: Sequence[str] = TOKEN_PACKS) -> KnobSpace:
    """The scan job's knob space on ``spec``'s geometry. Its constraint
    admits only the chunks the port's plan can cut (`plan_shards`: the
    shards equal and each a whole number of chunks), so no trial is spent
    re-measuring the declared chunk under another name."""

    def legal(cfg: TuningConfig) -> bool:
        applied = cfg.scan_chunk(spec.chunk_size, n_docs=spec.n_docs, n_shards=spec.n_shards)
        return applied == (cfg.chunk_size or spec.chunk_size)

    return KnobSpace(
        kind="scan_job",
        knobs=(
            Knob("chunk_size", tuple(chunk_values)),
            Knob("prefetch_depth", tuple(prefetch_values)),
            Knob("token_pack", tuple(token_packs)),
        ),
        constraint=legal,
    )


def state_bytes(state) -> bytes:
    return state.scores.cpu().numpy().tobytes() + state.ids.cpu().numpy().tobytes()


def scan_target(spec, coll, *, chunk_values: Sequence[int], prefetch_values: Sequence[int],
                repeats: int = 1, device=None, name: str = "scan") -> Target:
    """Bind `scan_space` to the scan job over ``coll`` (a prepared
    `runner.Collection`) on ``device`` (default ``cuda``). The default
    config's run is the oracle every trial is held to; a packed corpus is
    built once per resolved layout ("auto" and "bitpack" may be one)."""
    dev = resolve_device(device)
    scorers = spec.scorers()
    lexical = all(s.kind == "lexical" for s in scorers)
    space = scan_space(spec, chunk_values=chunk_values, prefetch_values=prefetch_values,
                       token_packs=TOKEN_PACKS if lexical else ("none",))
    queries = torch.as_tensor(coll.queries, device=dev)
    stats = type(coll.stats)(*(t.to(dev) for t in coll.stats))
    plain = (torch.as_tensor(coll.corpus.tokens, device=dev),
             torch.as_tensor(coll.corpus.lengths, device=dev))
    layouts: dict = {None: plain}

    def docs_for(cfg: TuningConfig):
        mode = cfg.token_pack if lexical else "none"
        layout = packing.make_spec(spec.vocab, spec.max_doc_len, mode)
        if layout not in layouts:
            layouts[layout] = packing.pack_corpus(
                coll.corpus.tokens, coll.corpus.lengths, vocab=spec.vocab, mode=mode
            ).to(dev)
        return layouts[layout]

    def run(cfg: TuningConfig):
        state = run_sharded_scan_job(
            queries, docs_for(cfg), scorers, k=spec.k,
            chunk_size=cfg.scan_chunk(spec.chunk_size, n_docs=spec.n_docs,
                                      n_shards=spec.n_shards),
            segment_chunks=spec.segment_chunks, n_shards=max(1, spec.n_shards), stats=stats,
            ckpt_dir=None, devices=[dev] if spec.n_shards > 1 else None, tuning=cfg,
        ).state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return state

    oracle = state_bytes(run(space.base))

    def measure(cfg: TuningConfig) -> float:
        if state_bytes(run(cfg)) != oracle:  # doubles as the warm-up
            raise AssertionError(
                f"byte-identity violated: {cfg.overrides()} changed the merged "
                "top-k state against the default config's"
            )
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(cfg)
            walls.append(time.perf_counter() - t0)
        return spec.n_docs * len(scorers) / float(np.median(walls))  # scored docs/s

    return Target(
        name=name, space=space, shape=scan_shape_sig_for(spec), backend=backend_sig(dev),
        measure=measure, run=run, oracle=oracle,
        meta={"spec": spec.name, "n_docs": spec.n_docs, "n_queries": spec.n_queries,
              "n_models": len(scorers), "n_shards": max(1, spec.n_shards),
              "declared_chunk": spec.chunk_size, "device": str(dev),
              "score_unit": "docs*models/s"},
    )


def tune_target(target: Target, *, budget: int, seed: int = 0, cache_path: str | None = None,
                log: Callable[[str], None] | None = None) -> dict:
    """Search one target, enforce the contracts, record the winner, and
    check the write → reload → hit round trip. Returns the report block."""
    result = search(target.space, target.measure, budget=budget, seed=seed, log=log)
    bad = [t for t in result.trials if t.error]
    if bad:
        raise RuntimeError(f"{target.name}: {len(bad)} trial(s) failed "
                           f"(first: {bad[0].config.overrides()} -> {bad[0].error})")
    if result.best.score < result.default.score:
        raise AssertionError((result.best.score, result.default.score))
    cache = TuneCache(cache_path)
    key = cache.put(kind=target.space.kind, shape=target.shape, config=result.best.config,
                    score=result.best.score, backend=target.backend,
                    meta={"target": target.name, "speedup_x": result.speedup_x, **target.meta})
    reloaded, hit = cache.get(kind=target.space.kind, shape=target.shape, backend=target.backend)
    if not hit or reloaded.config_hash() != result.best.config.config_hash():
        raise AssertionError(f"{target.name}: the winner is not found under its own key {key}")
    block = result.describe()
    block.update(shape=target.shape, backend=target.backend, cache_key=key, cache=cache.path,
                 cache_hit_roundtrip=True, byte_identity=True, meta=target.meta)
    return block
