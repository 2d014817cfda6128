"""The cluster's map and reduce: per-shard scan folds + the one merge.

Paper §2: **map** = sequentially scan one shard of the collection against
the full query and model-grid block; **reduce** = merge per-shard top-k
lists, at most ``k`` entries per query per shard crossing a shard boundary.

* :func:`map_shard` is the fold every shard runs (`scan.search_local_multi`
  with the shard's doc-id offset); :func:`segment_fold` binds that fold to
  one configuration (PyTorch runs eagerly: unlike the reference there is no
  compiled program to cache and share).
* :func:`reduce_states` is the k-bounded lexicographic bitonic merge
  (`topk.reduce_lex`): value-deterministic, so 1/2/4/N shards merge to the
  same bits.

The mesh scan (``scan_shards``, ``search_mesh``) waits for the mesh slice.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from repro_torch.core import scan, topk
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.tune import config as tune_config
from repro_torch.tune.config import TuningConfig


def map_shard(
    queries: Any,
    shard_docs: Any,
    scorers: Sequence[Scorer],
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    doc_id_offset: int = 0,
    init_state: topk.TopKState | None = None,
    use_kernel: bool = False,
    tuning: TuningConfig | None = None,
) -> topk.TopKState:
    """The map task: fold one shard into a stacked ``[n_models, n_q, k]``
    state. ``shard_docs`` is ``(tokens, lengths)`` for a lexical grid or a
    vector matrix ``[n, dim]`` for a dense one."""
    return scan.search_local_multi(
        queries,
        shard_docs,
        tuple(scorers),
        k=k,
        chunk_size=chunk_size,
        stats=stats,
        doc_id_offset=doc_id_offset,
        init_state=init_state,
        use_kernel=use_kernel,
        tuning=tuning,
    )


def segment_fold(
    scorers: Sequence[Scorer], *, k: int, chunk_size: int, use_kernel: bool = False,
    tuning: TuningConfig | None = None,
) -> Callable:
    """The per-segment fold of one configuration:
    ``fold(state, queries, seg_docs, stats, offset) -> TopKState``.

    ``tuning`` is resolved here, at fold-build time. ``use_kernel`` changes
    nothing (the device picks the path).
    """
    del use_kernel
    scorers = tuple(scorers)
    cfg = tune_config.resolve(tuning)

    def fold(state, queries, seg_docs, stats, offset):
        return map_shard(
            queries, seg_docs, scorers, k=k, chunk_size=chunk_size,
            stats=stats, doc_id_offset=int(offset), init_state=state, tuning=cfg,
        )

    return fold


def reduce_states(states: Sequence[topk.TopKState]) -> topk.TopKState:
    """The reduce task: lexicographic k-bounded merge of per-shard states."""
    states = list(states)
    if len(states) == 1:
        return states[0]
    return topk.reduce_lex(states)
