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
(`loadgen.MeteredSession`, `service.BatchRecord.latency_s`) times the
finished device work, as ``jax.block_until_ready`` makes it do in the
reference.

:class:`ShardedLexicalSession` (a corpus resident across a mesh) waits for
the mesh/executor slice.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import anchors, scan, topk
from repro_torch.core.scoring import PAD_TOKEN, CollectionStats, Scorer, get_scorer
from repro_torch.device import resolve_device
from repro_torch.tune import config as tune_config


def _to_host(state: topk.TopKState) -> topk.TopKState:
    return topk.TopKState(scores=state.scores.cpu(), ids=state.ids.cpu())


class LexicalSession:
    """Raw-token scan service state for one lexical scorer (ql_lm/bm25/...).

    Each block runs :func:`repro_torch.core.scan.search_local`: term
    frequencies recomputed from raw text, no index. ``tokens``/``lengths``
    may be numpy arrays or tensors; a tensor already on the session's device
    stays where it is. Packed resident corpora (``token_pack`` other than
    ``"none"``, passed in or set in the active tuning) wait for the packing
    slice.
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
        if token_pack != "none":
            raise NotImplementedError(
                f"token_pack={token_pack!r}: packed resident corpora wait for the "
                "packing slice of the port"
            )
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.k = k
        self.chunk_size = chunk_size
        tokens = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)
        self._lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        if tokens.shape[0] % chunk_size:
            raise ValueError(f"{tokens.shape[0]} docs not divisible by chunk {chunk_size}")
        if stats is None:
            if vocab is None:
                raise ValueError("need stats or vocab to derive collection statistics")
            stats = anchors.collection_stats(
                tokens, self._lengths, vocab=vocab, chunk_size=chunk_size
            )
        self._stats = CollectionStats(
            *(torch.as_tensor(x, device=self.device) for x in stats)
        )
        self._docs = (tokens, self._lengths)

    @property
    def n_docs(self) -> int:
        return int(self._lengths.shape[0])

    @property
    def pack_mode(self) -> str:
        """Resident storage: always ``none`` until the packing slice."""
        return "none"

    @property
    def resident_corpus_bytes(self) -> int:
        """Device bytes held by the resident corpus (tokens + lengths)."""
        return sum(t.numel() * t.element_size() for t in self._docs)

    def search(self, q_block: np.ndarray) -> topk.TopKState:
        """Scan one padded query block; returns once the results are on the
        host."""
        q = torch.as_tensor(np.asarray(q_block, np.int32), device=self.device)
        state = scan.search_local(
            q, self._docs, self.scorer, k=self.k, chunk_size=self.chunk_size,
            stats=self._stats,
        )
        return _to_host(state)


class ShardedLexicalSession:
    """A lexical session with the corpus resident *sharded* across a mesh:
    waits for the mesh/executor slice of the port."""

    kind = "lexical"
    pad_value = PAD_TOKEN

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedLexicalSession (a corpus sharded across a mesh) waits for the "
            "mesh/executor slice of the port"
        )


class DenseSession:
    """Vector-scan service state; every block launches the dense score +
    top-k kernel (`repro_torch.kernels.ops.score_topk`) on the card.

    Vectors are held as float32, as in the reference. A scorer with a row
    map (``dense_cosine``) has the resident vectors mapped once, here: rows
    are mapped independently, so the bits are those of mapping each chunk;
    each query block is mapped per call, and the block is then scanned as a
    dot product against the mapped corpus.
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
        self._vectors = rows(vecs) if rows is not None else vecs
        self._dot = get_scorer("dense_dot")

    @property
    def n_docs(self) -> int:
        return int(self._vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self._vectors.shape[1])

    def search(self, q_block: np.ndarray) -> topk.TopKState:
        """Scan one padded query block; returns once the results are on the
        host."""
        q = torch.as_tensor(np.asarray(q_block, np.float32), device=self.device)
        if self.scorer.row_map is not None:
            q = self.scorer.row_map(q)
        state = scan.search_local(
            q, self._vectors, self._dot, k=self.k, chunk_size=self.chunk_size
        )
        return _to_host(state)
