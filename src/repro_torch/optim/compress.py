"""Gradient compression for the data-parallel all-reduce, with error
feedback: top-k and sign (the port's copy of `repro.optim.compress`).

Each compressor adds the shard's residual (what it did not transmit last
step) to its gradient, keeps a compressed part, carries the rest forward as
the new residual and averages the kept parts over the ``dp`` shards (the
reference's ``pmean`` inside a ``shard_map``).

torch has no ``shard_map``: as the port's cross-shard merges do
(`repro_torch.core.topk.merge_across`), a compressor takes the shards'
trees as a list, one gradient tree and one `ErrorFeedbackState` a shard in
flat mesh order over ``axis_name``'s axes, and returns a list of what each
shard holds afterwards (every shard the same mean, each its own residual).
The mean adds the shards' parts left to right on each shard's device, then
divides by their count. A single tree (not a list) is one shard, whose
mean is its own part: the training driver passes its one global gradient,
as the reference's driver gives its compressor the gradient and the
residual replicated over ``dp``, so that every shard compresses the same
tree and their mean is that part.

``top_k`` of the magnitudes keeps the lower index first among equal
magnitudes (``torch.topk`` promises no order for ties, so the kept set is
taken by a stable descending sort, as ``lax.top_k`` orders them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.optim.adamw import tree_map


class ErrorFeedbackState(NamedTuple):
    residual: dict  # same structure as grads, float32


def ef_init(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def _topk_compress_leaf(g: torch.Tensor, frac: float):
    """Keep the top-k |values|: (values, flat indices)."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx


def _topk_decompress_leaf(vals, idx, shape):
    # the indices are distinct, so the reference's scatter-add is a scatter
    flat = torch.zeros((math.prod(shape),), dtype=vals.dtype, device=vals.device)
    return flat.scatter_(0, idx, vals).reshape(shape)


def _pmean(parts: list) -> list:
    """Every shard's mean of ``parts``: summed left to right on its device."""
    out = []
    for p in parts:
        total = None
        for q in parts:
            q = q.to(p.device)
            total = q if total is None else total + q
        out.append(total / len(parts))
    return out


def _allreduce(one, grads, ef):
    """Run ``one(g, r) -> (part, new_r)`` on every leaf of every shard, then
    average the parts over the shards."""
    single = not isinstance(grads, list)
    if single:
        grads, ef = [grads], [ef]
    n = len(grads)
    if n != len(ef):
        raise ValueError(f"{n} gradient trees for {len(ef)} residual trees")

    def leaf(*xs):  # one leaf of every shard: n gradients, then n residuals
        parts, resid = zip(*(one(g, r) for g, r in zip(xs[:n], xs[n:])))
        return [m.to(g.dtype) for m, g in zip(_pmean(list(parts)), xs[:n])], resid

    out = tree_map(leaf, *grads, *(e.residual for e in ef))
    reduced = [tree_map(lambda t, i=i: t[0][i], out) for i in range(n)]
    states = [ErrorFeedbackState(residual=tree_map(lambda t, i=i: t[1][i], out))
              for i in range(n)]
    return (reduced[0], states[0]) if single else (reduced, states)


def topk_allreduce(grads, ef, axis_name, *, frac: float = 0.01):
    """Error-feedback top-k all-reduce over ``axis_name``: each shard keeps
    ``frac`` of each leaf's coordinates (the largest of gradient plus
    residual), the rest becomes its residual, and the kept sparse tensors
    are averaged over the shards. ``grads``/``ef``: one tree, or a list of
    them by mesh coordinate (see the module docstring)."""
    del axis_name  # the list is the axis

    def one(g, r):
        acc = g.to(torch.float32) + r
        vals, idx = _topk_compress_leaf(acc, frac)
        sparse = _topk_decompress_leaf(vals, idx, acc.shape)
        return sparse, acc - sparse

    return _allreduce(one, grads, ef)


def sign_allreduce(grads, ef, axis_name):
    """Error-feedback signSGD with a per-tensor L1 scale: each shard sends
    ``sign(acc) * mean|acc|`` and keeps ``acc`` minus that as its residual;
    the parts are averaged over the shards."""
    del axis_name

    def one(g, r):
        acc = g.to(torch.float32) + r
        q = torch.sign(acc) * torch.mean(torch.abs(acc))
        return q, acc - q

    return _allreduce(one, grads, ef)
