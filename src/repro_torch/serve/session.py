"""Resident-corpus sessions: the corpus lives on the card, queries stream by.

A session owns one scorer kind's device-resident state — the token matrix,
lengths and collection statistics for lexical scans, the vector matrix for
dense scans — and scans each padded query block against it: the paper's
"keep the collection on the cluster, ship only queries and top-k back"
discipline, with device memory as the cluster.

Sessions are entry points: they run on ``cuda`` unless the caller passes
``device="cpu"`` (`repro_torch.resolve_device`), and the device picks the
path. On the card a lexical block launches the lexical kernel and a dense
block the dense kernel, once per block; on the CPU their plain versions
run. ``use_kernel`` is accepted and changes nothing.

``search`` uploads the query block to the session's device and returns a
:class:`~repro_torch.core.topk.TopKState` of host tensors. That copy to the
host is the synchronization point: a caller's clock around ``search``
(`loadgen.MeteredSession`) times the finished device work, as
``jax.block_until_ready`` makes it do in the reference.
:class:`LexicalSession` also splits it in two: ``launch`` enqueues a block
and its copy back and returns at once (:class:`Launched`), ``collect``
waits for that block alone, so a caller can prepare and launch the next
block while the card scans this one (`service.RetrievalService` does).

:class:`ShardedLexicalSession` keeps the corpus resident *sharded* across a
`repro_torch.distributed.sharding.Mesh` and reduces every block through the
cluster merge contract (`repro_torch.cluster.search_mesh`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import cluster, obs
from repro_torch.core import anchors, packing, pipeline, scan, topk
from repro_torch.core.scoring import PAD_TOKEN, CollectionStats, Scorer, get_scorer
from repro_torch.device import resolve_device
from repro_torch.kernels import lexical_scan
from repro_torch.kernels.score_topk import pad_rows
from repro_torch.tune import config as tune_config


def _to_host(state: topk.TopKState) -> topk.TopKState:
    return topk.TopKState(scores=state.scores.cpu(), ids=state.ids.cpu())


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into pinned host memory behind the work queued on the
    current stream, without the host waiting for it. Such a copy orders
    after nothing launched later, where ``.cpu()`` on the default stream
    would wait for every block launched since."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class Launched:
    """A block launched by :meth:`LexicalSession.launch`: its top k and,
    traced on a card, the kernel's counts for it, both copied into pinned
    host memory behind the kernel. ``event`` fires once they have landed,
    and the card sets ``landed[0]`` (pinned host memory) right after them;
    both are None where the launch completed at once, on the CPU. ``t0``
    and ``t1`` are the launch's start and end on the tracer's clock."""

    state: topk.TopKState
    counts: torch.Tensor | None
    event: torch.cuda.Event | None
    landed: np.ndarray | None
    t0: float
    t1: float

    def done(self) -> bool:
        """Whether the results are on the host; never waits. It reads the
        flag and makes no CUDA call, so a serving loop may ask it as often
        as it spins (each `torch.cuda.Event.query` would be a runtime call,
        and a traced window records every one)."""
        return self.landed is None or bool(self.landed[0])


def _pack_resident(tokens, lengths, *, vocab: int | None, mode: str, device):
    """The resident corpus of a lexical session on ``device``: the int32
    ``(tokens, lengths)`` tuple, or a `packing.PackedCorpus` when ``mode``
    resolves to a width for ``vocab``. The int32 matrix then never stays
    on the card, only the narrow one, and each scan decodes its tiles with
    bit-identical results. Packing needs the vocab (for the sentinel);
    without one the corpus stays unpacked rather than fail."""
    if mode != "none" and vocab is not None:
        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

        packed = packing.pack_corpus(host(tokens), host(lengths), vocab=vocab, mode=mode)
        if isinstance(packed, packing.PackedCorpus):
            return packed.to(device)
    return (torch.as_tensor(tokens, dtype=torch.int32, device=device),
            torch.as_tensor(lengths, dtype=torch.int32, device=device))


class LexicalSession:
    """Raw-token scan service state for one lexical scorer (ql_lm/bm25/...).

    Each block runs :func:`repro_torch.core.scan.search_local`: term
    frequencies recomputed from raw text, no index. ``tokens``/``lengths``
    may be numpy arrays or tensors; a tensor already on the session's device
    stays where it is. ``token_pack`` (passed in, or the active tuning's
    when ``None``) keeps the resident corpus packed at the width it resolves
    to (`packing.resolve_mode`), which the scan decodes tile by tile: fewer
    resident bytes, the same answers. ``vocab`` defaults to the size of the
    stats' ``cf`` table, as in the reference.
    """

    kind = "lexical"
    pad_value = PAD_TOKEN

    def __init__(
        self,
        tokens,
        lengths,
        scorer: Scorer | str,
        *,
        k: int,
        chunk_size: int,
        stats: CollectionStats | None = None,
        vocab: int | None = None,
        use_kernel: bool | None = None,
        token_pack: str | None = None,
        device=None,
    ):
        self.scorer = get_scorer(scorer) if isinstance(scorer, str) else scorer
        if self.scorer.kind != "lexical":
            raise ValueError(f"scorer {self.scorer.name!r} is not lexical")
        if token_pack is None:
            token_pack = tune_config.active().config.token_pack
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.k = k
        self.chunk_size = chunk_size
        if len(tokens) % chunk_size:
            raise ValueError(f"{len(tokens)} docs not divisible by chunk {chunk_size}")
        if stats is None:
            if vocab is None:
                raise ValueError("need stats or vocab to derive collection statistics")
            tokens = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
            lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
            stats = anchors.collection_stats(tokens, lengths, vocab=vocab, chunk_size=chunk_size)
        self._stats = CollectionStats(
            *(torch.as_tensor(x, device=self.device) for x in stats)
        )
        # the sentinel needs the vocab: the stats' cf table has one entry a term
        if vocab is None:
            vocab = int(self._stats.cf.shape[0])
        self._docs = _pack_resident(tokens, lengths, vocab=vocab, mode=token_pack,
                                    device=self.device)
        self._lengths = pipeline.leaves(self._docs)[1]
        # the value a launch copies into its handle's flag behind its results
        self._landed = torch.ones(1, dtype=torch.int32, device=self.device)

    @property
    def n_docs(self) -> int:
        return int(self._lengths.shape[0])

    @property
    def pack_mode(self) -> str:
        """Resolved resident storage: ``none`` or the PackSpec mode."""
        if isinstance(self._docs, packing.PackedCorpus):
            return self._docs.spec.mode
        return "none"

    @property
    def resident_corpus_bytes(self) -> int:
        """Device bytes held by the resident corpus (tokens + lengths)."""
        return packing.tree_nbytes(self._docs)

    def _scan(self, q: torch.Tensor, counters: torch.Tensor | None = None) -> topk.TopKState:
        return scan.search_local(q, self._docs, self.scorer, k=self.k,
                                 chunk_size=self.chunk_size, stats=self._stats,
                                 counters=counters)

    def launch(self, q_block: np.ndarray) -> Launched:
        """Enqueue one padded query block's scan and the copy of its top k
        to the host, and return without waiting for the card.

        On a card the block goes up from pinned memory and its results come
        back into pinned memory, all on the current stream, and an event
        marks their arrival; traced, the kernel counts into an array of the
        block's own, copied back with the results, and the launch holds
        ``session.upload`` (the block to the device), the scan's
        ``scan.epilogue`` and ``scan.launch`` (:meth:`collect` records the
        rest). On the CPU the block is searched here (:meth:`search`) and
        the handle is done at once.
        """
        if self.device.type != "cuda":
            return Launched(self.search(q_block), None, None, None, 0.0, 0.0)
        tr = obs.tracer()
        t0 = tr.now()
        with tr.span("session.upload", "session"):
            # from pinned memory: a blocking copy would wait for every block queued
            q = torch.as_tensor(np.asarray(q_block, np.int32)).pin_memory()
            q = q.to(self.device, non_blocking=True)
        counts = (torch.zeros(len(lexical_scan.COUNTERS), dtype=torch.int64, device=self.device)
                  if tr.enabled else None)
        state = self._scan(q, counts)
        state = topk.TopKState(scores=_pinned(state.scores), ids=_pinned(state.ids))
        counts = None if counts is None else _pinned(counts)
        # copied after the results on the same stream, so it lands after them
        landed = torch.zeros(1, dtype=torch.int32, pin_memory=True)
        landed.copy_(self._landed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return Launched(state, counts, event, landed.numpy(), t0, tr.now())

    def collect(self, handle: Launched) -> topk.TopKState:
        """Wait for a launched block's results and return them as host
        tensors of the caller's own (not pinned).

        Traced, a card's block records ``session.to_host`` (the launch's end
        to the results on the host: the wait for the card and the copy) and
        ``session.search`` (the launch's start to the same end), which
        carries the block's kernel counts.
        """
        if handle.event is None:
            return handle.state  # searched at launch, spans and all
        handle.event.synchronize()
        tr = obs.tracer()
        t2 = tr.now()
        tr.record("session.to_host", handle.t1, t2, "session")
        counts = ({} if handle.counts is None
                  else dict(zip(lexical_scan.COUNTERS, handle.counts.tolist())))
        tr.record("session.search", handle.t0, t2, "session", **counts)
        # numpy copies on this thread: `Tensor.clone` splits a 64-row block over
        # torch's worker threads, and waking them held the serving loop for up
        # to ~30 ms at times (on an H100 host under open-loop traffic)
        return topk.TopKState(scores=torch.from_numpy(handle.state.scores.numpy().copy()),
                              ids=torch.from_numpy(handle.state.ids.numpy().copy()))

    def search(self, q_block: np.ndarray) -> topk.TopKState:
        """Scan one padded query block; returns once the results are on the
        host. On a card, :meth:`collect` of :meth:`launch`.

        Traced, the call is ``session.search``, holding ``session.upload``
        (the block to the device), the scan's ``scan.epilogue`` and
        ``scan.launch``, and ``session.to_host`` (waiting for the device and
        the copy); on a card the span also carries the lexical kernel's
        counts for the block.
        """
        if self.device.type == "cuda":
            return self.collect(self.launch(q_block))
        tr = obs.tracer()
        with tr.span("session.search", "session"):
            with tr.span("session.upload", "session"):
                q = torch.as_tensor(np.asarray(q_block, np.int32), device=self.device)
            state = self._scan(q)
            with tr.span("session.to_host", "session"):
                return _to_host(state)


class ShardedLexicalSession:
    """Shard-resident lexical session: the corpus lives *sharded* on a mesh.

    The paper's cluster as a service: each shard's contiguous rows are
    resident on the shard's device (packed or not, ``token_pack`` as in
    :class:`LexicalSession`), the statistics are replicated on each device,
    every query block goes to every shard, each shard runs the same map
    fold as the single-device session (`cluster.map_shard`, one CUDA stream
    a shard on a card) and the shards' states reduce through the cluster
    merge contract (`topk.merge_across_lex`). So a sharded session's rows
    are bit-identical to :class:`LexicalSession`'s, whatever the mesh's
    shape. Drop-in for ``LexicalSession`` under
    `repro_torch.serve.service.RetrievalService` (same ``kind``/
    ``pad_value``/``search``, same ``[n_q, k]`` rows).

    Where every shard has the same device (one card: the mesh repeats
    ``cuda:0``), the corpus is resident once on it and each shard is a
    view of its rows, so the session holds :class:`LexicalSession`'s bytes;
    otherwise each device holds only its shards' rows. The plan is
    validated by `cluster.plan_for_mesh` (equal chunk-aligned shards over
    the scan axes). ``use_kernel`` is accepted and changes nothing.
    """

    kind = "lexical"
    pad_value = PAD_TOKEN

    def __init__(
        self,
        mesh,
        tokens,
        lengths,
        scorer: Scorer | str,
        *,
        k: int,
        chunk_size: int,
        stats: CollectionStats | None = None,
        vocab: int | None = None,
        use_kernel: bool | None = None,
        axis_names: tuple[str, ...] | None = None,
        token_pack: str | None = None,
    ):
        self.scorer = get_scorer(scorer) if isinstance(scorer, str) else scorer
        if self.scorer.kind != "lexical":
            raise ValueError(f"scorer {self.scorer.name!r} is not lexical")
        if token_pack is None:
            token_pack = tune_config.active().config.token_pack
        self.use_kernel = use_kernel
        self.k = k
        self.chunk_size = chunk_size
        self.mesh = mesh
        if axis_names is None:
            axis_names = cluster.mesh_scan_axes(mesh)
        self.axis_names = tuple(axis_names)
        self.plan = cluster.plan_for_mesh(mesh, len(tokens), chunk_size=chunk_size,
                                          axis_names=self.axis_names)
        self._scan = cluster.search_mesh(mesh, None, lengths, self.scorer, k=k,
                                         chunk_size=chunk_size, axis_names=self.axis_names)
        self.device = self._scan.home
        if stats is None:
            if vocab is None:
                raise ValueError("need stats or vocab to derive collection statistics")
            stats = anchors.collection_stats(
                torch.as_tensor(tokens, dtype=torch.int32, device=self.device),
                torch.as_tensor(lengths, dtype=torch.int32, device=self.device),
                vocab=vocab, chunk_size=chunk_size, mesh=mesh, axis_name=self.axis_names)
        stats = CollectionStats(*(torch.as_tensor(x) for x in stats))
        self._stats = self._scan.place_stats(stats)
        if vocab is None:
            vocab = int(stats.cf.shape[0])
        one_device = len(set(self._scan.devices)) == 1
        resident = _pack_resident(tokens, lengths, vocab=vocab, mode=token_pack,
                                  device=self.device if one_device else "cpu")
        self._shards = self._scan.place(resident)

    @property
    def n_docs(self) -> int:
        return self.plan.n_docs

    @property
    def pack_mode(self) -> str:
        """Resolved resident storage: ``none`` or the PackSpec mode."""
        if isinstance(self._shards[0], packing.PackedCorpus):
            return self._shards[0].spec.mode
        return "none"

    @property
    def resident_corpus_bytes(self) -> int:
        """Device bytes held by the resident corpus (tokens + lengths),
        over every shard."""
        return sum(packing.tree_nbytes(s) for s in self._shards)

    def search(self, q_block: np.ndarray) -> topk.TopKState:
        """Scan one padded query block across all shards; returns once the
        merged top-k is on the host."""
        q = torch.as_tensor(np.asarray(q_block, np.int32), device=self.device)
        state = self._scan.run_placed(q, self._shards, self._stats)
        # one scorer -> drop the grid axis: service rows are [n_q, k]
        return _to_host(topk.TopKState(scores=state.scores[0], ids=state.ids[0]))


class DenseSession:
    """Vector-scan service state; every block launches the dense score +
    top-k kernel (`repro_torch.kernels.ops.score_topk`) on the card.

    Vectors are held as float32, as in the reference. A scorer with a row
    map (``dense_cosine``) has the resident vectors mapped once, here: rows
    are mapped independently, so the bits are those of mapping each chunk;
    each query block is mapped per call, and the block is then scanned as a
    dot product against the mapped corpus. On a card the mapped vectors are
    zero-padded once to the kernel's row (`score_topk.pad_rows`, 32 float32), and
    each query block to the same width, so the kernel's wrapper copies
    nothing per block; zeros change no dot product and no norm.
    """

    kind = "dense"
    pad_value = 0.0

    def __init__(
        self,
        vectors,
        scorer: Scorer | str = "dense_dot",
        *,
        k: int,
        chunk_size: int,
        use_kernel: bool = True,
        device=None,
    ):
        self.scorer = get_scorer(scorer) if isinstance(scorer, str) else scorer
        if self.scorer.kind != "dense":
            raise ValueError(f"scorer {self.scorer.name!r} is not dense")
        self.device = resolve_device(device)
        self.k = k
        self.chunk_size = chunk_size
        self.use_kernel = use_kernel
        vecs = torch.as_tensor(vectors, device=self.device).to(torch.float32)
        if vecs.shape[0] % chunk_size:
            raise ValueError(f"{vecs.shape[0]} docs not divisible by chunk {chunk_size}")
        rows = self.scorer.row_map
        self._dim = int(vecs.shape[1])
        self._vectors = self._pad(rows(vecs) if rows is not None else vecs)
        self._dot = get_scorer("dense_dot")

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        """Zero columns up to the kernel's row width, on a card only: the
        CPU's plain version reads rows of any width, and a wider resident
        corpus would cost its memory for nothing."""
        return pad_rows(x) if x.device.type == "cuda" else x

    @property
    def n_docs(self) -> int:
        return int(self._vectors.shape[0])

    @property
    def dim(self) -> int:
        """The vectors' width as the caller gave it (before any pad)."""
        return self._dim

    def search(self, q_block: np.ndarray) -> topk.TopKState:
        """Scan one padded query block; returns once the results are on the
        host."""
        q = torch.as_tensor(np.asarray(q_block, np.float32), device=self.device)
        if self.scorer.row_map is not None:
            q = self.scorer.row_map(q)
        state = scan.search_local(
            self._pad(q), self._vectors, self._dot, k=self.k, chunk_size=self.chunk_size
        )
        return _to_host(state)
