"""Mergeable top-k state — the MIREX *combiner*, on torch.

The paper's reducer/combiner keeps a ranked list of at most ``k`` (doc,
score) pairs per query; the state is associative to merge, so it can be
kept per chunk (streaming scan), per segment (checkpointed job) or per
shard, and merged cheaply.

Order: every state is sorted by (score desc, id asc). The reference gets
that from ``lax.top_k``'s positional tie-break over a monotone-id candidate
stream; torch's ``topk`` gives no such promise on ties (BM25 scores every
document without a query term exactly 0, so ties are everywhere), so
:func:`update` takes a *stable* descending sort instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")


class TopKState(NamedTuple):
    """Running top-k of (score, id) pairs, sorted descending by score.

    Shapes: ``scores [..., k]`` float32, ``ids [..., k]`` int32. Empty slots
    have score ``-inf`` and id ``-1``.
    """

    scores: torch.Tensor
    ids: torch.Tensor

    @property
    def k(self) -> int:
        return self.scores.shape[-1]


def init(k: int, batch_shape: tuple = (), *, device=None, dtype=torch.float32) -> TopKState:
    """Fresh state with no entries."""
    return TopKState(
        scores=torch.full((*batch_shape, k), NEG_INF, dtype=dtype, device=device),
        ids=torch.full((*batch_shape, k), -1, dtype=torch.int32, device=device),
    )


def init_host(k: int, batch_shape: tuple = ()) -> TopKState:
    """:func:`init` as host (numpy) arrays — same sentinel contract."""
    return TopKState(
        scores=np.full((*batch_shape, k), NEG_INF, np.float32),
        ids=np.full((*batch_shape, k), -1, np.int32),
    )


def valid_mask(state: TopKState) -> torch.Tensor:
    """Boolean mask of occupied slots (a corpus smaller than k leaves empties)."""
    return (state.ids >= 0) & (state.scores > NEG_INF)


def sort_key(scores: torch.Tensor) -> torch.Tensor:
    """Scores as a sort key in which ``-0.0`` equals ``+0.0``, as the
    float comparisons of the merge network and the kernel treat them
    (a radix sort on raw float bits would order them apart)."""
    return scores + 0.0


def update(state: TopKState, cand_scores: torch.Tensor, cand_ids: torch.Tensor) -> TopKState:
    """Fold a block of candidates into the state (the combiner step).

    ``cand_scores [..., m]``, ``cand_ids [..., m]``. A stable descending sort
    over ``state ++ candidates`` keeps, among equal scores, the earlier
    position first — exactly ``lax.top_k``'s tie-break in the reference.
    """
    all_scores = torch.cat([state.scores, cand_scores.to(state.scores.dtype)], dim=-1)
    all_ids = torch.cat([state.ids, cand_ids.to(torch.int32)], dim=-1)
    _, pos = torch.sort(sort_key(all_scores), dim=-1, descending=True, stable=True)
    pos = pos[..., : state.k]
    return TopKState(
        scores=torch.gather(all_scores, -1, pos), ids=torch.gather(all_ids, -1, pos)
    )


def merge(a: TopKState, b: TopKState) -> TopKState:
    """Associative merge of two states (reduce step)."""
    return update(a, b.scores, b.ids)


def merge_lex(a: TopKState, b: TopKState) -> TopKState:
    """k-bounded **lexicographic** merge — the cluster reduce contract.

    Both inputs must be sorted by (score desc, id asc). One bitonic merge
    network (`kernels.score_topk.bitonic_merge_desc`), so the output is a
    pure function of the two value sets: no dependence on merge order or
    shard count. Inputs are right-padded to a power-of-two width with
    ``(-inf, -1)`` empty slots.
    """
    from repro_torch.kernels.score_topk import _pad_desc, bitonic_merge_desc

    if a.scores.shape != b.scores.shape:
        raise ValueError(f"merge_lex shape mismatch: {a.scores.shape} != {b.scores.shape}")
    k = a.k
    width = 1 if k <= 1 else 1 << (k - 1).bit_length()  # next pow2
    a_s, a_i = _pad_desc(a.scores, a.ids, width)
    b_s, b_i = _pad_desc(b.scores, b.ids, width)
    s, i = bitonic_merge_desc(a_s, a_i, b_s, b_i)
    return TopKState(scores=s[..., :k], ids=i[..., :k])


def reduce_lex(states) -> TopKState:
    """Fold any number of per-shard states through :func:`merge_lex`."""
    states = list(states)
    if not states:
        raise ValueError("reduce_lex needs at least one state")
    out = states[0]
    for s in states[1:]:
        out = merge_lex(out, s)
    return out


def topk_dense(scores: torch.Tensor, k: int) -> TopKState:
    """One-shot top-k over a dense score row (utility for baselines/tests),
    positional tie-break like ``lax.top_k``."""
    _, ids = torch.sort(sort_key(scores), dim=-1, descending=True, stable=True)
    ids = ids[..., :k]
    return TopKState(scores=torch.gather(scores, -1, ids), ids=ids.to(torch.int32))
