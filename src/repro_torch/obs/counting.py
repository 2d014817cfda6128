"""The hooks through which the kernels and the cross-shard merges report to
an op counter in force (`repro_torch.launch.opcount.OpCounter`).

The lowest layers (`kernels.ops`, `distributed.sharding`, `core.topk`,
`models.moe`, `models.gnn`) call these and nothing of the launch layer. With
no counter in force each is a no-op, or runs its body as it is.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

_ACTIVE: list = []


def push(counter) -> None:
    """Put ``counter`` in force (innermost)."""
    _ACTIVE.append(counter)


def pop(counter) -> None:
    _ACTIVE.remove(counter)


def active():
    """The innermost counter in force, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel(name: str, cost: Callable[[], dict], run: Callable[[], Any]):
    """Run a kernel wrapper's body: ``run()`` as it is with no counter in
    force; under one, ``cost()`` (``{"flops": {class: n}, "bytes": n}``) is
    charged to it under ``name`` and ``run()`` runs uncounted, its outputs
    counted as live."""
    counter = active()
    if counter is None:
        return run()
    return counter.charge_kernel(name, cost(), run)


def collective(kind: str, payload: float, group: int) -> None:
    """Record a collective of ``kind`` among ``group`` shards, ``payload``
    bytes a member (``hloparse``'s figure: the op's output bytes on one
    device). A group of one moves nothing."""
    counter = active()
    if counter is not None and group > 1:
        counter.record_collective(kind, payload, group)


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree, out=None) -> list[torch.Tensor]:
    """The tensors in a tree of tuples, lists, dicts and named tuples (an
    op's arguments and results; faster than a general pytree flatten)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            tensors_of(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors_of(x, out)
    return out


def each_shard(n: int, body: Callable[[int], Any], *, meta: bool) -> list:
    """``[body(i) for i in range(n)]``, the shards of a mesh one after
    another. Under a counter, when ``meta`` (the caller's inputs are
    ``meta`` tensors and none needs a gradient), every shard's body has the
    same shapes and no values, so ``body(0)`` runs once, is counted ``n``
    times, and its result stands for every shard's (the caller promises
    equal shapes). Nothing else changes: on real tensors, or with a
    gradient to take, each shard runs."""
    counter = active()
    if counter is None or not meta or n == 1:
        return [body(i) for i in range(n)]
    with counter.repeat(n):
        first = body(0)
    return [first] * n
