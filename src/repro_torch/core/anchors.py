"""Corpus-preparation MapReduce job: collection statistics.

The paper runs a collection-statistics job before searching; its output
feeds the LM and BM25 scorers. The combiner state is additive, so the job is
a chunked fold (:func:`repro_torch.core.pipeline.fold_chunks`) over exact
int32 counters. Anchor-text extraction (``repro.core.anchors.
extract_anchors``) waits for a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core import pipeline
from repro_torch.core.scoring import PAD_TOKEN, CollectionStats


def _chunk_stats(chunk_tokens: torch.Tensor, vocab: int):
    """Per-chunk (cf, df, total) from raw padded token rows, exact int32."""
    valid = chunk_tokens != PAD_TOKEN
    toks = chunk_tokens[valid].long()
    cf = torch.bincount(toks, minlength=vocab)[:vocab].to(torch.int32)
    # df: count each term at most once per document — sort each row (pads
    # sort last as vocab), keep first occurrences
    sorted_toks = torch.sort(torch.where(valid, chunk_tokens, vocab), dim=-1).values
    first = torch.ones_like(sorted_toks, dtype=torch.bool)
    first[:, 1:] = sorted_toks[:, 1:] != sorted_toks[:, :-1]
    first &= sorted_toks < vocab
    df = torch.bincount(sorted_toks[first].long(), minlength=vocab)[:vocab].to(torch.int32)
    # int32 accumulator, as the reference: fine below 2^31 terms
    total = valid.sum(dtype=torch.int32)
    return cf, df, total


def collection_stats(
    d_tokens: torch.Tensor,
    d_len: torch.Tensor,
    vocab: int,
    *,
    chunk_size: int = 256,
) -> CollectionStats:
    """The statistics job: additive int32 counters over chunks of rows."""
    dev = d_tokens.device
    state0 = (
        torch.zeros((vocab,), dtype=torch.int32, device=dev),
        torch.zeros((vocab,), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )

    def fold(state, chunk, start):
        del start
        tokens, lens = chunk
        cf, df, total = _chunk_stats(tokens, vocab)
        n_docs = (lens > 0).sum(dtype=torch.int32)
        return (state[0] + cf, state[1] + df, state[2] + total, state[3] + n_docs)

    cf, df, total, n_docs = pipeline.fold_chunks((d_tokens, d_len), chunk_size, fold, state0)
    avg = total.to(torch.float32) / torch.clamp(n_docs.to(torch.float32), min=1.0)
    return CollectionStats(cf=cf, df=df, total_terms=total, n_docs=n_docs, avg_doc_len=avg)
