"""Mergeable top-k state — the MIREX *combiner*, on torch.

The paper's reducer/combiner keeps a ranked list of at most ``k`` (doc,
score) pairs per query; the state is associative to merge, so it can be
kept per chunk (streaming scan), per segment (checkpointed job) or per
shard, and merged cheaply.

The cross-shard merges (:func:`merge_across_lex`, :func:`merge_across`,
:func:`merge_across_tree`) run inside ``shard_map`` in the reference, each
shard holding its own state. Here there is no SPMD program: they take the
shards' states as one object array indexed by mesh coordinates
(:func:`state_array`), the names of its dims (``axes``) and the axes to
reduce, and return an array of the same shape holding what each shard
holds after the reference's collective, on that shard's device.

Order: every state is sorted by (score desc, id asc). The reference gets
that from ``lax.top_k``'s positional tie-break over a monotone-id candidate
stream; torch's ``topk`` gives no such promise on ties (BM25 scores every
document without a query term exactly 0, so ties are everywhere), so
:func:`update` takes a *stable* descending sort instead.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.obs import counting

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


def state_array(states: Sequence[TopKState], shape: tuple[int, ...] | None = None) -> np.ndarray:
    """The states in mesh order (row-major) as an object array of ``shape``
    (default 1-d). ``np.array`` would split each state into its two
    tensors, so the array is filled one element at a time."""
    states = list(states)
    arr = np.empty(len(states), dtype=object)
    for i, s in enumerate(states):
        arr[i] = s
    return arr.reshape(shape if shape is not None else (len(states),))


def _state_bytes(state: TopKState) -> int:
    return counting.tensor_bytes(state.scores) + counting.tensor_bytes(state.ids)


def _record_stages(states: np.ndarray, names, axes, kind: str) -> None:
    """Tell an op counter in force of a merge's collectives, one stage an
    axis: each fiber's all-gather of its states (``"all-gather"``, the
    gathered bytes a member) or each round of the butterfly
    (``"collective-permute"``, one state a member)."""
    if counting.active() is None:
        return
    one = _state_bytes(states.flat[0])
    for a in (names,) if isinstance(names, str) else names:
        n = states.shape[list(axes).index(a)]
        fibers = states.size // n
        for _ in range(fibers):
            if kind == "all-gather":
                counting.collective(kind, n * one, n)
            else:
                for _ in range(max(n - 1, 0).bit_length()):
                    counting.collective(kind, one, n)


def _to(state: TopKState, device) -> TopKState:
    """The state on ``device`` (no copy when it is there already)."""
    return TopKState(scores=state.scores.to(device), ids=state.ids.to(device))


def merge_across_lex(states: np.ndarray, axis_name: str | Sequence[str], *,
                     axes: Sequence[str]) -> np.ndarray:
    """Global lexicographic reduce across mesh axes.

    ``states`` holds one state per shard, its dims named by ``axes``. The
    reference's hierarchical staging: one stage per axis of ``axis_name``,
    in order, each gathering the axis's states and folding them with
    :func:`merge_lex` in shard order (cutting back to ``k`` between
    stages), so the mesh reduce and the host-loop reduce (:func:`reduce_lex`)
    share one merge contract. Every shard of a reduced fiber holds the same
    state.
    """
    _record_stages(states, axis_name, axes, "all-gather")
    for a in (axis_name,) if isinstance(axis_name, str) else axis_name:
        states = pipeline.merge_across(states, a, merge_lex, axes=axes)
    return states


def merge_across(states: np.ndarray, axis_name: str | Sequence[str], *,
                 axes: Sequence[str], method: str = "staged") -> np.ndarray:
    """Global reduce: merge per-shard states across mesh axes, one stage per
    axis (re-reducing to ``k`` between stages, so a stage's buffer is
    ``axis_size * k`` a query).

    ``method="staged"`` is the reference's top ``k`` of an axis's
    ``[n_shards, k]`` lists flattened in shard order, the lower position
    first on a tie (``lax.top_k``). That is the left fold of :func:`merge`
    over the shards (a stable sort: ``torch.topk`` promises no order for
    ties on CUDA): every truncation to ``k`` keeps the order of (score,
    position). ``method="tree"`` is :func:`merge_across_tree`.
    """
    if method not in ("staged", "tree"):
        raise ValueError(f"unknown merge method {method!r}")
    if method == "staged":
        _record_stages(states, axis_name, axes, "all-gather")
    for a in (axis_name,) if isinstance(axis_name, str) else axis_name:
        if method == "tree":
            states = merge_across_tree(states, a, axes=axes)
        else:
            states = pipeline.merge_across(states, a, merge, axes=axes)
    return states


def merge_across_tree(states: np.ndarray, axis_name: str, *,
                      axes: Sequence[str]) -> np.ndarray:
    """Log-depth butterfly merge along one axis (recursive halving, the
    reference's ``ppermute`` rounds): in round ``step`` shard ``i`` merges
    its partner ``i ^ step``'s state into its own with :func:`merge` (its
    own entries first on a tie). The axis size must be a power of two. Every
    shard ends with the global top ``k``; on tied scores shards may hold
    them in another order, as in the reference."""
    if axis_name not in axes:
        raise ValueError(f"axis {axis_name!r} is not one of the states' axes {tuple(axes)}")
    dim = list(axes).index(axis_name)
    n = states.shape[dim]
    if n & (n - 1):
        raise ValueError(f"tree merge requires power-of-two axis size, got {n}")
    _record_stages(states, axis_name, axes, "collective-permute")
    out = np.empty(states.shape, dtype=object)
    src, dst = np.moveaxis(states, dim, -1), np.moveaxis(out, dim, -1)
    for idx in np.ndindex(src.shape[:-1]):
        fiber, step = list(src[idx]), 1
        while step < n:
            fiber = [merge(fiber[i], _to(fiber[i ^ step], fiber[i].scores.device))
                     for i in range(n)]
            step <<= 1
        for j, state in enumerate(fiber):
            dst[idx + (j,)] = state
    return out


def topk_dense(scores: torch.Tensor, k: int) -> TopKState:
    """One-shot top-k over a dense score row (utility for baselines/tests),
    positional tie-break like ``lax.top_k``."""
    _, ids = torch.sort(sort_key(scores), dim=-1, descending=True, stable=True)
    ids = ids[..., :k]
    return TopKState(scores=torch.gather(scores, -1, ids), ids=ids.to(torch.int32))
