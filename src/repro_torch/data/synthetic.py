"""Deterministic synthetic data: Zipf corpora, queries and qrels.

The same generators as the JAX package's `repro.data.synthetic`, byte for
byte for every seed: the corpora, queries and qrels come from numpy's
``default_rng`` in the reference's draw order. What changed is only how the
work is done, so that a corpus of millions of documents is prepared in
seconds instead of minutes:

* the Zipf draw replays ``Generator.choice(p=...)`` — uniform doubles
  inverted through the same CDF — in bounded chunks, inverting on
  ``device`` (an exact comparison search);
* the row fill is one masked assignment in row-major order instead of a
  Python loop over documents;
* the qrels' query-term counts run on ``device`` (exact integers), and the
  densest documents are selected by a partition instead of a full sort,
  unless a tie makes the order depend on the sort (then the full sort runs).

:func:`make_dense_corpus` and :func:`make_lm_batch` are the reference's
numpy code as it is, and so are the recsys batches (:func:`make_recsys_batch`,
:func:`make_item_sequences`). :func:`make_links` (the anchor job's link
graph) draws its destinations through the same replayed ``choice`` and
fills its anchor rows by one masked assignment. :func:`make_graph` (the
GNN's power-law graph) draws its sources through the same replayed
``choice`` and sorts the edges by destination on ``device`` (a stable sort
has one answer, the reference's ``np.argsort(kind="stable")``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.scoring import PAD_TOKEN

# doubles drawn and inverted per step of the Zipf draw (256 MiB of float64)
_DRAW_CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class Corpus:
    tokens: np.ndarray  # [n_docs, max_len] int32, PAD_TOKEN-padded
    lengths: np.ndarray  # [n_docs] int32


def _zipf_tokens(
    rng: np.random.Generator, n: int, vocab: int, alpha: float, device="cpu"
) -> np.ndarray:
    """Zipf-ish token ids in [0, vocab): ``rng.choice(vocab, size=n, p=...)``.

    ``Generator.choice`` with ``p`` normalizes the CDF, draws ``n`` uniform
    doubles and returns ``cdf.searchsorted(u, side="right")``; this replays
    those steps chunk by chunk (the uniform stream is the same whether drawn
    at once or in pieces), so the ids are the reference's exactly.
    """
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    cdf_t = torch.as_tensor(cdf, device=device)
    out = np.empty(n, np.int32)
    for a in range(0, n, _DRAW_CHUNK):
        u = torch.as_tensor(rng.random(min(_DRAW_CHUNK, n - a)), device=device)
        idx = torch.searchsorted(cdf_t, u, right=True)
        out[a : a + len(u)] = idx.to(torch.int32).cpu().numpy()
    return out


def make_corpus(
    *,
    n_docs: int,
    vocab: int,
    max_len: int = 64,
    min_len: int = 8,
    alpha: float = 1.1,
    seed: int = 0,
    device="cpu",
) -> Corpus:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=n_docs).astype(np.int32)
    tokens = np.full((n_docs, max_len), PAD_TOKEN, np.int32)
    flat = _zipf_tokens(rng, int(lengths.sum()), vocab, alpha, device)
    # row-major mask order == the reference's row-by-row fill
    tokens[np.arange(max_len)[None, :] < lengths[:, None]] = flat
    return Corpus(tokens=tokens, lengths=lengths)


def make_queries(
    corpus: Corpus,
    *,
    n_queries: int,
    max_q_len: int = 4,
    seed: int = 1,
) -> np.ndarray:
    """Queries sampled from corpus text (so they have matches), padded."""
    rng = np.random.default_rng(seed)
    n_docs = corpus.tokens.shape[0]
    q = np.full((n_queries, max_q_len), PAD_TOKEN, np.int32)
    for i in range(n_queries):
        qlen = int(rng.integers(1, max_q_len + 1))
        doc = int(rng.integers(0, n_docs))
        dlen = int(corpus.lengths[doc])
        picks = rng.integers(0, dlen, size=qlen)
        q[i, :qlen] = corpus.tokens[doc, picks]
    return q


def make_links(
    *,
    n_docs: int,
    n_links: int,
    vocab: int,
    max_anchor_len: int = 6,
    seed: int = 3,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Power-law link graph + anchor token strings for the anchor job:
    ``(dst [n_links] int32, tokens [n_links, max_anchor_len] int32)``.

    The reference's draws in its order: destinations by
    ``rng.choice(n_docs, p=w)`` with ``w ∝ rank^-0.9`` (replayed by
    :func:`_zipf_tokens`, whose CDF is that ``w``'s), then each anchor's
    length, then its Zipf tokens. Each anchor fills its row from column 0,
    which is the row-major order of the length mask.
    """
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish dst distribution
    dst = _zipf_tokens(rng, n_links, n_docs, 0.9, device)
    tokens = np.full((n_links, max_anchor_len), PAD_TOKEN, np.int32)
    lens = rng.integers(1, max_anchor_len + 1, size=n_links)
    flat = _zipf_tokens(rng, int(lens.sum()), vocab, 1.05, device)
    tokens[np.arange(max_anchor_len)[None, :] < lens[:, None]] = flat
    return dst, tokens


def make_dense_corpus(*, n_docs: int, dim: int, seed: int = 4) -> np.ndarray:
    """Unit-norm float32 document vectors ``[n_docs, dim]`` (seeded)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_docs, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _top_by_density(density: np.ndarray, per_query: int) -> np.ndarray:
    """``np.argsort(-density)[:per_query]`` in linear time when no tie can
    make the order depend on the sort algorithm; the full sort otherwise."""
    neg = -density
    n = neg.shape[0]
    if per_query >= n:
        return np.argsort(neg)[:per_query]
    part = np.argpartition(neg, per_query - 1)[:per_query]
    vals = neg[part]
    distinct = np.unique(vals).size == per_query
    if distinct and np.count_nonzero(neg <= vals.max()) == per_query:
        return part[np.argsort(vals)]
    return np.argsort(neg)[:per_query]


def _density_ranked(
    corpus: Corpus, queries: np.ndarray, per_query: int, seed: int, device="cpu"
) -> list[np.ndarray]:
    """Per query: the ``per_query`` densest matching docs, best first.

    The single source of the synthetic gold standard — binary and graded
    qrels both consume this ranking."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(corpus.lengths, 1)
    tokens = torch.as_tensor(corpus.tokens, device=device)
    ranked = []
    for qi in range(queries.shape[0]):
        terms = queries[qi][queries[qi] != PAD_TOKEN]
        counts = torch.zeros(tokens.shape[0], dtype=torch.int64, device=device)
        for t in terms:
            counts += (tokens == int(t)).sum(-1)
        # integer counts are exact in float64, as the reference's running sum
        density = counts.cpu().numpy().astype(np.float64)
        density = density / lengths
        density += rng.normal(0, 1e-9, density.shape)  # tie-break
        top = _top_by_density(density, per_query)
        ranked.append(top[density[top] > 0])
    return ranked


def make_qrels(
    corpus: Corpus,
    queries: np.ndarray,
    *,
    per_query: int = 20,
    seed: int = 2,
    device="cpu",
) -> np.ndarray:
    """Synthetic relevance: for each query the docs with the highest raw
    query-term density are 'relevant'."""
    qrels = np.zeros((queries.shape[0], corpus.tokens.shape[0]), bool)
    for qi, top in enumerate(_density_ranked(corpus, queries, per_query, seed, device)):
        qrels[qi, top] = True
    return qrels


def make_graded_qrels(
    corpus: Corpus,
    queries: np.ndarray,
    *,
    per_query: int = 20,
    max_grade: int = 3,
    seed: int = 2,
    device="cpu",
) -> np.ndarray:
    """Graded relevance (0..max_grade) for NDCG: same density ranking as
    :func:`make_qrels`, with grades assigned by rank band (denser ⇒ higher)."""
    qrels = np.zeros((queries.shape[0], corpus.tokens.shape[0]), np.int8)
    for qi, top in enumerate(_density_ranked(corpus, queries, per_query, seed, device)):
        for rank, doc in enumerate(top):
            band = rank * max_grade // max(len(top), 1)  # 0 = densest band
            qrels[qi, doc] = max_grade - band
    return qrels


def make_lm_batch(
    *, batch: int, seq_len: int, vocab: int, seed: int = 0, chunk: int = 0
) -> dict[str, np.ndarray]:
    """Deterministic LM batch keyed by (seed, chunk): Zipf-distributed
    tokens ``[batch, seq_len]`` and their next-token labels, int32, byte
    for byte the reference's."""
    rng = np.random.default_rng((seed, chunk))
    tokens = _zipf_tokens(rng, batch * (seq_len + 1), vocab, 1.2).reshape(
        batch, seq_len + 1
    )
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
    }


def make_graph(
    *, n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 16, seed: int = 5,
    device="cpu",
) -> dict[str, np.ndarray]:
    """Random power-law graph (COO edge list, sorted by dst for segment ops).

    The reference's draws in its order: sources by ``rng.choice(n_nodes,
    p=w)`` with ``w ∝ rank^-0.8`` (replayed by :func:`_zipf_tokens`), then
    destinations, features and labels.
    """
    rng = np.random.default_rng(seed)
    src = _zipf_tokens(rng, n_edges, n_nodes, 0.8, device)
    dst = rng.integers(0, n_nodes, size=n_edges, dtype=np.int32)
    order = torch.sort(torch.as_tensor(dst, device=device), stable=True).indices
    order = order.cpu().numpy()
    return {
        "src": src[order],
        "dst": dst[order],
        "x": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "y": rng.integers(0, n_classes, size=n_nodes, dtype=np.int32),
    }


def make_recsys_batch(
    *,
    batch: int,
    n_dense: int,
    n_sparse: int,
    vocab_per_field: int,
    seed: int = 0,
    chunk: int = 0,
) -> dict[str, np.ndarray]:
    """A click batch keyed by (seed, chunk), byte for byte the reference's:
    ``dense [B, n_dense]`` float32, ``sparse_ids [B, n_sparse]`` int32 and
    ``labels [B]`` float32 from a fixed linear teacher over the dense
    features plus a per-field id-parity term (learnable, not coin flips)."""
    rng = np.random.default_rng((seed, chunk))
    dense = (
        rng.standard_normal((batch, n_dense)).astype(np.float32)
        if n_dense
        else np.zeros((batch, 0), np.float32)
    )
    sparse_ids = rng.integers(0, vocab_per_field, size=(batch, n_sparse), dtype=np.int32)
    logit = dense @ np.linspace(-1.0, 1.0, n_dense) if n_dense else np.zeros(batch)
    if n_sparse:
        logit = logit + 0.5 * ((sparse_ids[:, 0] % 2) * 2 - 1)
    return {
        "dense": dense,
        "sparse_ids": sparse_ids,
        "labels": (logit > 0).astype(np.float32),
    }


def make_item_sequences(
    *, batch: int, seq_len: int, n_items: int, seed: int = 0, chunk: int = 0
) -> dict[str, np.ndarray]:
    """Item histories keyed by (seed, chunk), byte for byte the reference's:
    ``history [B, S]`` and the next items ``target [B, S]``, int32 in
    ``1..n_items-1``."""
    rng = np.random.default_rng((seed, chunk))
    seq = rng.integers(1, n_items, size=(batch, seq_len + 1), dtype=np.int32)
    return {"history": seq[:, :-1], "target": seq[:, 1:]}
