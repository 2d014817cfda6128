"""Inverted-index baseline — the paper's comparison system (Lemur stand-in).

MIREX §3.2 compares the sequential scan against Lemur running
query-at-a-time retrieval over an inverted index. Claim C2 (the per-query
gap closes as query sets grow) needs that baseline, so here it is: a CSR
postings index (term -> [(doc, tf)]) built once, plus query-at-a-time
scoring that evaluates the same Hiemstra LM / BM25 formulas as the scan.
Identical math makes ``search(...) == scan`` a correctness oracle for the
whole engine, not only a wall-clock baseline.

The port's copy of `repro.core.invindex`: a host (numpy) job, as there —
the 2010-style system whose construction cost is what MIREX avoids; the
experiment measures its query path, term at a time with float64
accumulators. Its arrays are the reference's byte for byte.
:func:`stats_from_index` returns the port's `CollectionStats` (torch
tensors on the CPU; ``total_terms`` int64 as the reference's), and
:func:`search` takes statistics on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.scoring import PAD_TOKEN, CollectionStats


@dataclasses.dataclass
class InvertedIndex:
    offsets: np.ndarray  # [vocab+1] CSR offsets into postings
    doc_ids: np.ndarray  # [nnz]
    tfs: np.ndarray  # [nnz]
    doc_len: np.ndarray  # [n_docs]
    n_docs: int
    vocab: int

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.shape[0])


def build_index(d_tokens: np.ndarray, d_len: np.ndarray, vocab: int) -> InvertedIndex:
    """One pass over the corpus -> CSR postings sorted by (term, doc)."""
    d_tokens = np.asarray(d_tokens)
    d_len = np.asarray(d_len)
    n_docs, _ = d_tokens.shape
    rows, cols = np.nonzero(d_tokens != PAD_TOKEN)
    terms = d_tokens[rows, cols]
    # unique (term, doc) pairs with counts = tf
    keys = terms.astype(np.int64) * n_docs + rows
    uniq, tf = np.unique(keys, return_counts=True)
    u_terms = (uniq // n_docs).astype(np.int32)
    u_docs = (uniq % n_docs).astype(np.int32)
    offsets = np.zeros(vocab + 1, np.int64)
    np.add.at(offsets[1:], u_terms, 1)
    offsets = np.cumsum(offsets)
    return InvertedIndex(
        offsets=offsets,
        doc_ids=u_docs,
        tfs=tf.astype(np.int32),
        doc_len=np.maximum(d_len.astype(np.int32), 1),
        n_docs=n_docs,
        vocab=vocab,
    )


def stats_from_index(index: InvertedIndex) -> CollectionStats:
    """The index already holds the collection statistics; export them."""
    cf = np.zeros(index.vocab, np.int32)
    df = np.zeros(index.vocab, np.int32)
    term_of = np.searchsorted(index.offsets, np.arange(index.nnz), side="right") - 1
    np.add.at(cf, term_of, index.tfs)
    np.add.at(df, term_of, 1)
    total = int(index.tfs.sum())
    return CollectionStats(
        cf=torch.from_numpy(cf),
        df=torch.from_numpy(df),
        total_terms=torch.tensor(total, dtype=torch.int64),
        n_docs=torch.tensor(index.n_docs, dtype=torch.int32),
        avg_doc_len=torch.tensor(np.float32(total / max(index.n_docs, 1))),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def search(
    index: InvertedIndex,
    q_tokens,
    stats: CollectionStats,
    *,
    k: int,
    scorer: str = "ql_lm",
    lam: float = 0.15,
    k1: float = 1.2,
    b: float = 0.75,
) -> tuple[np.ndarray, np.ndarray]:
    """Query-at-a-time TAAT retrieval. Returns (scores [n_q,k], ids [n_q,k])."""
    q_tokens = _host(q_tokens)
    cf = _host(stats.cf).astype(np.float64)
    df = _host(stats.df).astype(np.float64)
    total = float(_host(stats.total_terms))
    n = float(_host(stats.n_docs))
    avgdl = float(_host(stats.avg_doc_len))
    dlen = index.doc_len.astype(np.float64)

    n_q = q_tokens.shape[0]
    out_scores = np.full((n_q, k), -np.inf, np.float32)
    out_ids = np.full((n_q, k), -1, np.int32)
    for qi in range(n_q):
        terms = q_tokens[qi]
        terms = terms[terms != PAD_TOKEN]
        if scorer == "ql_lm":
            acc = np.log(dlen).copy()  # length prior
        else:
            acc = np.zeros(index.n_docs, np.float64)
        for t in terms:
            t = int(t)
            lo, hi = index.offsets[t], index.offsets[t + 1]
            if hi == lo or cf[t] == 0:
                continue
            docs = index.doc_ids[lo:hi]
            tf = index.tfs[lo:hi].astype(np.float64)
            if scorer == "ql_lm":
                odds = lam * tf * total / ((1.0 - lam) * cf[t] * dlen[docs])
                acc[docs] += np.log1p(odds)
            elif scorer == "bm25":
                idf = np.log1p((n - df[t] + 0.5) / (df[t] + 0.5))
                norm = k1 * (1.0 - b + b * dlen[docs] / avgdl)
                acc[docs] += idf * tf * (k1 + 1.0) / (tf + norm)
            else:
                raise ValueError(f"indexed baseline does not implement {scorer!r}")
        top = np.argpartition(-acc, min(k, index.n_docs - 1))[:k]
        top = top[np.argsort(-acc[top], kind="stable")]
        out_scores[qi, : top.size] = acc[top]
        out_ids[qi, : top.size] = top
    return out_scores, out_ids
