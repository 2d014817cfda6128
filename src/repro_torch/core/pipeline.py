"""MapReduce-shaped dataflow on torch: chunked folds over a local shard.

The three-stage shape of the paper's Figure 1 — map over an input split,
fold into an associative *combiner* state, merge states across machines —
is the skeleton of the scan, the statistics job and the sharded job:

    state = fold_chunks(local_shard, chunk, fold_fn, init)   # map + combine

``fold_chunks`` is a Python loop over chunks (PyTorch runs eagerly, so there
is no compiled scan to build). Chunk folds are idempotent re-reduces: the
combiner state is associative, so a re-executed chunk merges to the same
result.

A "pytree" here is a tensor or a tuple of tensors whose leading dims agree
(``(tokens, lengths)`` for a lexical corpus).
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

import torch

S = TypeVar("S")


def leaves(tree: Any) -> list:
    """The tensors of a tensor-or-tuple tree, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor of a tensor-or-tuple tree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def num_chunks(n: int, chunk_size: int) -> int:
    return -(-n // chunk_size)


def segments(n: int, chunk_size: int, chunks_per_segment: int) -> list[tuple[int, int]]:
    """Chunk-aligned ``[start, stop)`` row ranges for checkpointed folds.

    Every boundary is a chunk boundary, so the segmented fold replays the
    exact per-chunk fold sequence of the unsegmented one.
    """
    if n % chunk_size:
        raise ValueError(f"leading dim {n} not divisible by chunk_size {chunk_size}")
    if chunks_per_segment < 1:
        raise ValueError(f"chunks_per_segment must be >= 1, got {chunks_per_segment}")
    step = chunk_size * chunks_per_segment
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_leading(tree: Any, n_target: int, pad_values: Any = None) -> Any:
    """Pad every leaf's leading dim to ``n_target`` (with leaf-specific fill)."""

    def _pad(x, fill):
        pad = n_target - x.shape[0]
        if pad == 0:
            return x
        filler = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, filler])

    if pad_values is None:
        return tree_map(lambda x: _pad(x, 0), tree)
    xs, fills = leaves(tree), leaves(pad_values)
    padded = iter([_pad(x, f) for x, f in zip(xs, fills)])
    return tree_map(lambda _: next(padded), tree)


def fold_chunks(
    data: Any,
    chunk_size: int,
    fold_fn: Callable[[S, Any, int], S],
    init_state: S,
) -> S:
    """Map+combine over a local shard, ``chunk_size`` rows at a time.

    ``fold_fn(state, chunk, chunk_start) -> state``. The leading dim of every
    leaf must be divisible by ``chunk_size`` (use :func:`pad_leading`);
    ``chunk_start`` is the row offset of the chunk within the local shard.
    """
    n = leaves(data)[0].shape[0]
    if n % chunk_size:
        raise ValueError(f"leading dim {n} not divisible by chunk_size {chunk_size}")
    state = init_state
    for start in range(0, n, chunk_size):
        chunk = tree_map(lambda x, a=start: x[a : a + chunk_size], data)
        state = fold_fn(state, chunk, start)
    return state
