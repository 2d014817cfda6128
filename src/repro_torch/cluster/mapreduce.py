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
* :func:`scan_shards` is the uncheckpointed host loop over a plan's shards
  (round-robin over ``devices``), :func:`search_mesh` the whole job over a
  `distributed.sharding.Mesh`: the corpus sharded over the scan axes, each
  shard's map on its device (one CUDA stream a shard), the hierarchical
  lexicographic reduce (`topk.merge_across_lex`) onto the mesh's first
  device. Checkpointed jobs run the host loop in `cluster.job`.

The reference caches its compiled folds and mesh programs (``_FOLD_CACHE``,
``_SharedFold``, ``_MESH_CACHE``); PyTorch runs eagerly and the port
compiles nothing at run time, so there is nothing to cache or share.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.cluster.plan import ShardPlan, mesh_scan_axes
from repro_torch.core import pipeline, scan, topk
from repro_torch.core.scoring import CollectionStats, Scorer
from repro_torch.distributed.sharding import Mesh
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


def _stats_to(stats: CollectionStats | None, device) -> CollectionStats | None:
    return None if stats is None else CollectionStats(*(t.to(device) for t in stats))


def scan_shards(
    plan: ShardPlan,
    queries: Any,
    docs: Any,
    scorers: Sequence[Scorer],
    *,
    k: int,
    stats: CollectionStats | None = None,
    use_kernel: bool = False,
    devices: Sequence | None = None,
    tuning: TuningConfig | None = None,
) -> topk.TopKState:
    """Uncheckpointed host-driven sharded scan: map every shard, reduce once.

    ``devices`` places shard ``i`` on ``devices[i % len(devices)]`` (its
    rows, the queries and the statistics are copied there; a device already
    holding them copies nothing), and the states are gathered onto
    ``devices[0]`` for the reduce; ``None`` folds every shard where the
    docs lie. Checkpointed and concurrent execution live in
    `cluster.job.run_sharded_scan_job`.
    """
    n_rows = pipeline.leaves(docs)[0].shape[0]
    if n_rows != plan.n_docs:
        raise ValueError(f"docs have {n_rows} rows but plan covers {plan.n_docs}")
    fold = segment_fold(scorers, k=k, chunk_size=plan.chunk_size, use_kernel=use_kernel,
                        tuning=tuning)
    states = []
    for shard in plan.shards:
        shard_docs, q, st = shard.take(docs), queries, stats
        if devices:
            dev = torch.device(devices[shard.index % len(devices)])
            shard_docs = pipeline.tree_map(lambda x: x.to(dev), shard_docs)
            q, st = pipeline.tree_map(lambda x: x.to(dev), queries), _stats_to(stats, dev)
        states.append(fold(None, q, shard_docs, st, shard.doc_id_offset))
    if devices:
        home = torch.device(devices[0])
        states = [topk.TopKState(*(t.to(home) for t in s)) for s in states]
    return reduce_states(states)


class MeshSearch:
    """The callable :func:`search_mesh` returns: ``(queries, docs, stats)
    -> TopKState`` stacked ``[n_models, n_q, k]``, on the mesh's first
    shard's device.

    Shard ``i`` (flat over ``axis_names``, row-major) scans rows ``[i *
    per_shard, (i + 1) * per_shard)`` with ``doc_id_offset = i *
    per_shard`` on its device, through :func:`map_shard`. On a card each
    shard runs on a CUDA stream of its own, made here, which first waits
    for the caller's stream (where the queries were made); the caller's
    stream on the first shard's device then waits for every shard's stream
    before it gathers and merges, and ``record_stream`` marks each tensor
    used on a stream other than the one that allocated it, so the caching
    allocator cannot hand its memory out while that stream may still read
    it. Nothing in a call waits for the host. Where devices repeat (one
    card), a shard's rows are a view of the corpus and nothing is copied.

    :meth:`place` cuts a corpus into its shards on their devices and
    :meth:`place_stats` replicates the statistics onto them, once, for a
    caller that keeps them resident (`serve.ShardedLexicalSession`);
    :meth:`run_placed` scans shards so placed.
    """

    def __init__(self, mesh: Mesh, axis_names: tuple[str, ...], scorers: tuple[Scorer, ...],
                 *, k: int, chunk_size: int, n_docs: int, tuning: TuningConfig):
        self.mesh, self.axis_names, self.scorers = mesh, axis_names, scorers
        self.k, self.chunk_size, self.tuning = k, chunk_size, tuning
        self.sizes = tuple(mesh.shape[a] for a in axis_names)
        n_shards = 1
        for n in self.sizes:
            n_shards *= n
        if n_docs % n_shards:
            raise ValueError(f"{n_docs} docs not divisible by {n_shards} shards")
        self.n_docs, self.per_shard = n_docs, n_docs // n_shards
        self.devices = [mesh.shard(i, axis_names)[0] for i in range(n_shards)]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def place(self, docs: Any) -> list:
        """Each shard's rows on its device (views where the corpus lies
        there already)."""
        n = pipeline.leaves(docs)[0].shape[0]
        if n != self.n_docs:
            raise ValueError(f"docs have {n} rows, the mesh scan was built for {self.n_docs}")
        p = self.per_shard
        return [pipeline.tree_map(lambda x, a=i * p, d=dev: x[a : a + p].to(d), docs)
                for i, dev in enumerate(self.devices)]

    def place_stats(self, stats: CollectionStats | None) -> list:
        """The statistics on each shard's device (the same tensors where
        they lie there already)."""
        return [_stats_to(stats, dev) for dev in self.devices]

    def __call__(self, queries: Any, docs: Any, stats: CollectionStats | None = None):
        return self.run_placed(queries, self.place(docs), self.place_stats(stats))

    def run_placed(self, queries: Any, shard_docs: list,
                   shard_stats: list) -> topk.TopKState:
        states = []
        for i, (dev, stream, docs, st) in enumerate(
                zip(self.devices, self.streams, shard_docs, shard_stats)):
            q = pipeline.tree_map(lambda x, d=dev: x.to(d, non_blocking=True), queries)
            kw = dict(k=self.k, chunk_size=self.chunk_size, stats=st,
                      doc_id_offset=i * self.per_shard, tuning=self.tuning)
            if stream is None:
                states.append(map_shard(q, docs, self.scorers, **kw))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            for x in pipeline.leaves((q, docs)) + list(st or ()):
                x.record_stream(stream)
            with torch.cuda.stream(stream):
                states.append(map_shard(q, docs, self.scorers, **kw))
        if self.home.type == "cuda":
            main = torch.cuda.current_stream(self.home)
            for stream, state in zip(self.streams, states):
                main.wait_stream(stream)
                for x in state:
                    x.record_stream(main)
        states = [topk.TopKState(*(x.to(self.home, non_blocking=True) for x in s))
                  for s in states]
        merged = topk.merge_across_lex(topk.state_array(states, self.sizes), self.axis_names,
                                       axes=self.axis_names)
        return merged[(0,) * len(self.sizes)]


def search_mesh(
    mesh: Mesh,
    queries: Any,
    docs: Any,
    scorers: Sequence[Scorer] | Scorer,
    *,
    k: int,
    chunk_size: int,
    stats: CollectionStats | None = None,
    axis_names: tuple[str, ...] | None = None,
    use_kernel: bool = False,
    tuning: TuningConfig | None = None,
) -> MeshSearch:
    """The whole MIREX job over a mesh: the corpus sharded over
    ``axis_names`` (default every mesh axis — the logical "scan" axis),
    queries and statistics replicated, each shard's :func:`map_shard`, then
    the hierarchical lexicographic reduce.

    Returns a :class:`MeshSearch` ``(queries, docs, stats) -> TopKState``
    with stacked ``[n_models, n_q, k]`` shapes (``n_models == 1`` for a
    single scorer). As in the reference, ``queries``/``docs``/``stats`` here
    are prototypes: only the corpus's row count, which fixes the shards'
    id offsets, is read. Merged rankings equal the one-shard scan's bit for
    bit at any mesh shape. ``use_kernel`` changes nothing (the device picks
    the path). Nothing is memoized: the reference caches its traced
    ``shard_map`` program (``_MESH_CACHE``), and the port compiles nothing.
    """
    del queries, stats, use_kernel
    scorers = (scorers,) if isinstance(scorers, Scorer) else tuple(scorers)
    if axis_names is None:
        axis_names = mesh_scan_axes(mesh)
    return MeshSearch(mesh, tuple(axis_names), scorers, k=k, chunk_size=chunk_size,
                      n_docs=pipeline.leaves(docs)[0].shape[0],
                      tuning=tune_config.resolve(tuning))
