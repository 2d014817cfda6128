"""The sequential-scan search engine — MIREX's map phase, on torch.

One pass over a corpus shard scores every query against every document and
keeps a running top-k per query. :func:`search_local_multi` folds a whole
*grid* of lexical scorers in that one pass: the term-frequency reduction is
computed once per chunk and shared by every model.

The device picks the path. On CUDA tensors the scan launches the CUDA
lexical-scan kernel (`repro_torch.kernels.ops.lexical_scan_topk`); on CPU
tensors it runs that kernel's plain PyTorch version, which folds chunk by
chunk exactly as the reference's host fold does. ``use_kernel`` is accepted
so the reference's signatures carry over and changes nothing here: the
reference's host fold and its interpret-mode kernel both map to the plain
version on the CPU.

Dense scans (``search_local`` with a dense scorer), the mesh scan and the
dense host oracle wait for the dense slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import pipeline, scoring, topk
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.tune import config as tune_config
from repro_torch.tune.config import TuningConfig


def _check_chunking(docs: Any, chunk_size: int) -> None:
    """Refuse corpus shards the chunked fold / kernel grid cannot cover."""
    n = pipeline.leaves(docs)[0].shape[0]
    if n % chunk_size:
        raise ValueError(
            f"corpus has {n} rows, not a multiple of chunk_size {chunk_size}; "
            "pad the shard first (pipeline.pad_leading with PAD_TOKEN rows)"
        )


def _offset_ids(ids: torch.Tensor, doc_id_offset) -> torch.Tensor:
    """Local row -> global doc id, preserving the -1 empty-slot sentinel."""
    return torch.where(ids >= 0, ids + int(doc_id_offset), ids)


def search_local(
    queries: Any,
    docs: Any,
    scorer: Scorer,
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    doc_id_offset: int = 0,
    use_kernel: bool = False,
    tuning: TuningConfig | None = None,
) -> topk.TopKState:
    """Scan a local corpus shard with one lexical scorer; top-k (global doc
    ids) per query, shapes ``[n_q, k]``. ``use_kernel`` changes nothing."""
    if scorer.kind != "lexical":
        raise NotImplementedError("dense scans wait for the dense slice of the port")
    state = search_local_multi(
        queries, docs, (scorer,), k=k, chunk_size=chunk_size, stats=stats,
        doc_id_offset=doc_id_offset, use_kernel=use_kernel, tuning=tuning,
    )
    return topk.TopKState(scores=state.scores[0], ids=state.ids[0])


def search_local_multi(
    queries: Any,
    docs: Any,
    scorers: tuple[Scorer, ...] | list[Scorer],
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    doc_id_offset: int = 0,
    init_state: topk.TopKState | None = None,
    use_kernel: bool = False,
    tuning: TuningConfig | None = None,
) -> topk.TopKState:
    """Scan a corpus shard once, scoring a whole *grid* of lexical models.

    Returns a stacked :class:`topk.TopKState` with shapes ``[n_models, n_q,
    k]``; row ``m`` equals ``search_local(..., scorer=scorers[m])``.
    ``init_state`` resumes from a checkpointed state: this pass's k-bounded
    result merges into it (associativity of the combiner makes the
    segmented fold equal to the unsegmented one). ``use_kernel`` changes
    nothing: CUDA tensors always take the kernel, CPU tensors its plain
    version.
    """
    del use_kernel
    scorers = tuple(scorers)
    if not scorers:
        raise ValueError("need at least one scorer")
    kinds = {s.kind for s in scorers}
    if len(kinds) != 1:
        raise ValueError(f"multi-scorer scan needs a single kind, got {sorted(kinds)}")
    if kinds.pop() != "lexical":
        raise NotImplementedError("dense scans wait for the dense slice of the port")
    _check_chunking(docs, chunk_size)
    n_q = pipeline.leaves(queries)[0].shape[0]
    if init_state is not None:
        if init_state.scores.shape[:-1] != (len(scorers), n_q):
            raise ValueError(
                f"init_state batch shape {tuple(init_state.scores.shape[:-1])} "
                f"!= ({len(scorers)}, {n_q})"
            )
        if init_state.k != k:
            raise ValueError(f"init_state has k={init_state.k}, requested k={k}")

    from repro_torch.kernels import ops

    cfg = tune_config.resolve(tuning)
    d_tokens, d_len = docs
    modes, weights, ab = scoring.lexical_epilogues(scorers, queries, stats)
    scores, ids = ops.lexical_scan_topk(
        queries, weights, ab, d_tokens, d_len, modes=modes, k=k,
        block_d=cfg.lex_block(chunk_size, d_tokens.shape[0]), tile_d=cfg.lex_tile_d,
    )
    state = topk.TopKState(scores=scores, ids=_offset_ids(ids, doc_id_offset))
    if init_state is not None:
        state = topk.merge(init_state, state)
    return state
