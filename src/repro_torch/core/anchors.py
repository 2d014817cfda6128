"""Corpus-preparation MapReduce jobs: collection statistics + anchor text.

The paper runs two jobs before searching: (1) collection statistics that
feed the LM and BM25 scorers (term/document frequencies), and (2)
anchor-text extraction, which groups the link anchor strings pointing *at*
each page into that page's searchable representation (§3.2). The
statistics job's combiner state is additive, so it is a chunked fold
(:func:`repro_torch.core.pipeline.fold_chunks`) over exact int32 counters,
and over a mesh each shard's counters are summed in shard order
(:func:`repro_torch.core.pipeline.merge_across`, the reference's ``psum``);
the anchor job is integer work on the device the links live on (a stable
sort by destination, each link's rank within its group, one scatter).
"""

from __future__ import annotations

import math

import numpy as np
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


def _local_stats(d_tokens, d_len, vocab: int, chunk_size: int):
    """One shard's ``(cf, df, total, n_docs)`` int32 counters."""
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

    return pipeline.fold_chunks((d_tokens, d_len), chunk_size, fold, state0)


def collection_stats(
    d_tokens: torch.Tensor,
    d_len: torch.Tensor,
    vocab: int,
    *,
    chunk_size: int = 256,
    mesh=None,
    axis_name: str | tuple[str, ...] | None = None,
) -> CollectionStats:
    """The statistics job: additive int32 counters over chunks of rows.

    With a ``mesh`` (`repro_torch.distributed.sharding.Mesh`) the rows are
    cut into equal contiguous shards over ``axis_name`` (default: every
    mesh axis), each shard counts its rows on its device, and the counters
    are summed across the shards — the reference's ``axis_name`` path,
    where each shard of a ``shard_map`` counts its own rows and ``psum``
    merges them. Integer counts: the result equals the unsharded job's
    exactly, on the mesh's first shard's device.
    """
    if mesh is None:
        state = _local_stats(d_tokens, d_len, vocab, chunk_size)
    else:
        names = tuple(mesh.axis_names) if axis_name is None else (
            (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))
        sizes = tuple(mesh.shape[a] for a in names)
        n_shards = math.prod(sizes)
        n = d_tokens.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} docs not divisible into {n_shards} equal shards")
        per = n // n_shards
        parts = np.empty(n_shards, dtype=object)
        for i in range(n_shards):
            dev, _ = mesh.shard(i, names)
            rows = slice(i * per, (i + 1) * per)
            parts[i] = _local_stats(d_tokens[rows].to(dev), d_len[rows].to(dev), vocab,
                                    chunk_size)
        merged = pipeline.merge_across(parts.reshape(sizes), names, axes=names)
        state = merged[(0,) * len(names)]
    cf, df, total, n_docs = state
    avg = total.to(torch.float32) / torch.clamp(n_docs.to(torch.float32), min=1.0)
    return CollectionStats(cf=cf, df=df, total_terms=total, n_docs=n_docs, avg_doc_len=avg)


def extract_anchors(
    link_dst: torch.Tensor,
    link_tokens: torch.Tensor,
    *,
    n_docs: int,
    max_anchor_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-text extraction: group anchor strings by destination page.

    ``link_dst [E]`` destination doc ids, ``link_tokens [E, L_a]`` anchor
    token ids (PAD_TOKEN-padded). Returns the anchor-text document
    representation ``(tokens [n_docs, max_anchor_len], lens [n_docs] int32)``,
    the tokens in ``link_tokens``' dtype, as the reference lays it out: the
    ``r``-th link to a page (in link order) puts its non-PAD tokens at
    columns ``r * L_a + j``, so a short anchor leaves PAD gaps inside the
    row, and tokens past ``max_anchor_len`` are dropped.

    Destinations index rows as the reference's ``.at[...].set(mode="drop")``
    does: a negative id in ``[-n_docs, 0)`` counts from the end, any other
    id outside ``[0, n_docs)`` is dropped. Only the tokens kept are
    scattered (an out-of-range index would be a device-side assert on a
    card), in two passes in the reference's update order — the wrapped
    negative groups first — so that where a page is reached both ways its
    own group's tokens win, as they do there.
    """
    e, l_a = link_tokens.shape
    dev = link_tokens.device
    out = torch.full((n_docs, max_anchor_len), PAD_TOKEN, dtype=link_tokens.dtype, device=dev)
    if e:
        dst_sorted, order = torch.sort(link_dst, stable=True)
        toks_sorted = link_tokens[order]
        # rank of each link within its destination group
        group_start = torch.searchsorted(dst_sorted, dst_sorted, side="left")
        rank = torch.arange(e, device=dev) - group_start
        cols = rank[:, None] * l_a + torch.arange(l_a, device=dev)[None, :]
        wrapped = dst_sorted < 0
        rows = torch.where(wrapped, dst_sorted.long() + n_docs, dst_sorted.long())
        keep = (toks_sorted != PAD_TOKEN) & (cols < max_anchor_len)
        keep &= ((rows >= 0) & (rows < n_docs))[:, None]
        target = rows[:, None] * max_anchor_len + cols
        flat = out.view(-1)
        for sel in (keep & wrapped[:, None], keep & ~wrapped[:, None]):
            flat[target[sel]] = toks_sorted[sel]
    lens = (out != PAD_TOKEN).sum(-1, dtype=torch.int32)
    return out, lens
