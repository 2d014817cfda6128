"""The sequential-scan search engine — MIREX's map phase, on torch.

One pass over a corpus shard scores every query against every document and
keeps a running top-k per query. :func:`search_local_multi` folds a whole
*grid* of scorers: for a lexical grid in one pass, the term-frequency
reduction computed once per chunk and shared by every model; for a dense
grid one pass per scorer.

The device picks the path. On CUDA tensors the scan launches the CUDA
kernels (`repro_torch.kernels.ops.lexical_scan_topk` for lexical scorers,
`ops.score_topk` for dense ones); on CPU tensors it runs their plain
PyTorch versions, which fold chunk by chunk as the reference's host fold
does. ``use_kernel`` is accepted so the reference's signatures carry over
and changes nothing here.

A dense scorer is the dot product of its ``row_map``-ed rows
(`scoring.Scorer`): ``dense_cosine`` normalises queries and documents as
`scoring.dense_cosine` does, then takes the dot product. That is the
reference's host fold (``use_kernel=False``) on every device; the
reference's own kernel path drops the row map and returns dot products for
``dense_cosine``. :func:`search_dense_host` is the unblocked test oracle.

A lexical ``docs`` may be a `packing.PackedCorpus`: its packed tokens,
lengths and spec go to `ops.lexical_scan_topk` as they are (the kernel
decodes each tile, the plain version each block), with results equal to
the unpacked corpus's bit for bit. A dense scorer on a packed corpus is
refused.

The mesh scan is `repro_torch.cluster.search_mesh`; :func:`search_sharded`
is its deprecated alias, as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import obs
from repro_torch.core import packing, pipeline, scoring, topk
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


def _dense_scan(queries, docs, scorer: Scorer, *, k: int, chunk_size: int,
                cfg: TuningConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One dense scorer over a shard -> ``(scores, local ids) [n_q, k]``."""
    from repro_torch.kernels import ops

    if scorer.row_map is not None:
        queries, docs = scorer.row_map(queries), scorer.row_map(docs)
    return ops.score_topk(
        queries.contiguous(), docs.contiguous(), k=k,
        block_d=cfg.dense_block(chunk_size, docs.shape[0]),
    )


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
    counters: torch.Tensor | None = None,
) -> topk.TopKState:
    """Scan a local corpus shard with one scorer; top-k (global doc ids) per
    query, shapes ``[n_q, k]``.

    ``docs`` is ``(tokens [n, L], lens [n])`` or a `packing.PackedCorpus`
    for lexical scorers, or a vector matrix ``[n, dim]`` for dense scorers;
    ``n`` must be a multiple of ``chunk_size``. ``use_kernel`` changes
    nothing. ``counters``: as in :func:`search_local_multi`.
    """
    state = search_local_multi(
        queries, docs, (scorer,), k=k, chunk_size=chunk_size, stats=stats,
        doc_id_offset=doc_id_offset, use_kernel=use_kernel, tuning=tuning,
        counters=counters,
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
    counters: torch.Tensor | None = None,
) -> topk.TopKState:
    """Scan a corpus shard, scoring a whole *grid* of models of one kind.

    Returns a stacked :class:`topk.TopKState` with shapes ``[n_models, n_q,
    k]``; row ``m`` equals ``search_local(..., scorer=scorers[m])``. A
    lexical grid scans in one kernel pass; a dense grid launches the dense
    kernel once per scorer.
    ``init_state`` resumes from a checkpointed state: this pass's k-bounded
    result merges into it (associativity of the combiner makes the
    segmented fold equal to the unsegmented one). ``use_kernel`` changes
    nothing: CUDA tensors always take the kernel, CPU tensors its plain
    version. ``counters``: the array a lexical kernel adds its counts into
    (`ops.lexical_scan_topk`), else the device's own.
    """
    del use_kernel
    scorers = tuple(scorers)
    if not scorers:
        raise ValueError("need at least one scorer")
    kinds = {s.kind for s in scorers}
    if len(kinds) != 1:
        raise ValueError(f"multi-scorer scan needs a single kind, got {sorted(kinds)}")
    kind = kinds.pop()
    packed = isinstance(docs, packing.PackedCorpus)
    if packed and kind != "lexical":
        raise ValueError(f"a packed corpus holds tokens; {kind} scorers need vectors")
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

    cfg = tune_config.resolve(tuning)
    if kind == "dense":
        results = [_dense_scan(queries, docs, s, k=k, chunk_size=chunk_size, cfg=cfg)
                   for s in scorers]
        scores = torch.stack([r[0] for r in results])
        ids = torch.stack([r[1] for r in results])
    else:
        from repro_torch.kernels import ops

        if packed:
            d_tokens, d_len, pack_spec = docs.tokens, docs.lengths, docs.spec
        else:
            (d_tokens, d_len), pack_spec = docs, None
        tr = obs.tracer()
        with tr.span("scan.epilogue", "scan"):
            modes, weights, ab = scoring.lexical_epilogues(scorers, queries, stats)
        # on a card: the host's time to enqueue the kernels
        with tr.span("scan.launch", "scan"):
            scores, ids = ops.lexical_scan_topk(
                queries, weights, ab, d_tokens, d_len, modes=modes, k=k,
                block_d=cfg.lex_block(chunk_size, d_tokens.shape[0]), tile_d=cfg.lex_tile_d,
                pack_spec=pack_spec, counters=counters,
            )
    state = topk.TopKState(scores=scores, ids=_offset_ids(ids, doc_id_offset))
    if init_state is not None:
        state = topk.merge(init_state, state)
    return state


def search_sharded(
    mesh,
    axis_names: tuple[str, ...],
    queries: Any,
    docs: Any,
    scorer: Scorer,
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    use_kernel: bool = False,
    tree_merge: bool = False,
):
    """Deprecated alias for :func:`repro_torch.cluster.search_mesh`.

    Keeps the old single-scorer return shape (``[n_q, k]``) by squeezing
    the grid axis; ``tree_merge`` is ignored (the hierarchical
    lexicographic reduce bounds the gather buffer at ``axis_size * k``
    already).
    """
    import warnings

    warnings.warn(
        "scan.search_sharded is deprecated; use repro.cluster.search_mesh "
        "(multi-model, kernel-dispatched, shared merge contract)",
        DeprecationWarning,
        stacklevel=2,
    )
    del tree_merge
    from repro_torch import cluster  # local import: scan is cluster's lower layer

    fn = cluster.search_mesh(
        mesh, queries, docs, scorer,
        k=k, chunk_size=chunk_size, stats=stats,
        axis_names=axis_names, use_kernel=use_kernel,
    )

    def squeezed(queries, docs, stats=None):
        state = fn(queries, docs, stats)
        return topk.TopKState(scores=state.scores[0], ids=state.ids[0])

    return squeezed


def search_dense_host(q_vecs: torch.Tensor, d_vecs: torch.Tensor, k: int) -> topk.TopKState:
    """Unblocked oracle (materializes the full score matrix) for tests."""
    scores = q_vecs.to(torch.float32) @ d_vecs.to(torch.float32).T
    return topk.topk_dense(scores, k)
