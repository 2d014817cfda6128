"""The hooks through which the kernels and the cross-shard merges report to
an op counter in force (`repro_torch.launch.opcount.OpCounter`).

The lowest layers (`kernels.ops`, `distributed.sharding`, `core.topk`,
`models.moe`, `models.gnn`) call these and nothing of the launch layer. With
no counter in force each is a no-op, or runs its body as it is.
"""

from __future__ import annotations

import contextlib
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


def repeated(n: int):
    """A context in which the counter in force counts what runs ``n``
    times (nothing changes with no counter)."""
    counter = active()
    return contextlib.nullcontext() if counter is None else counter.repeat(n)


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


def _under_saved_tensor_hooks() -> bool:
    """Do saved-tensor hooks (a non-reentrant checkpoint's forward) pack
    what autograd saves here? (False where this torch cannot say.)"""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks", None)
    return top is not None and top(True) is not None


def _in_backward() -> bool:
    """Is a backward pass running this code (a checkpoint's recompute)?"""
    task = getattr(torch._C, "_current_graph_task_id", None)
    return task is not None and task() != -1


def _run_keeping_saved(body, leaves) -> tuple[Any, bool]:
    """``body(0, *leaves)`` on a graph of its own: the tensors it saves for
    its backward are kept by the graph itself, out of any outer
    checkpoint's hooks. Returns its result and whether it saved any."""
    saved = []

    def pack(x):
        saved.append(True)
        return x

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = body(0, *leaves)
    return out, bool(saved)


class _Repeated(torch.autograd.Function):
    """One shard's body standing for ``n`` under a counter, with a gradient:
    the forward runs ``body(0, *inputs)`` under ``counter.repeat(n)`` on a
    graph of its own, and the backward takes that graph's gradient under
    ``counter.repeat(n)`` too, so both ways are charged ``n`` times.

    A remat around it: where every shard runs (the card), a checkpoint's
    recompute runs a body again if the body saved tensors (the backward
    needs them), and stops before one that saved none. Here the body's
    saved tensors are kept from the checkpoint, whose recompute so stops
    before the body; the backward itself runs the forward once more,
    charged ``n`` times, where the forward ran inside a checkpoint and
    saved tensors. A recompute that does rerun the forward (an outer
    checkpoint of a two-level remat, which recomputes the inner
    checkpoints' forwards) is charged as a forward."""

    @staticmethod
    def forward(ctx, counter, n, body, *inputs):
        leaves = [x.detach().requires_grad_(need) if isinstance(x, torch.Tensor) else x
                  for x, need in zip(inputs, ctx.needs_input_grad[3:])]
        rerun = _in_backward()  # a checkpoint's recompute
        with counter.repeat(n):
            out, saved = _run_keeping_saved(body, leaves)
        ctx.remat = saved and not rerun and _under_saved_tensor_hooks()
        outs = out if isinstance(out, tuple) else (out,)
        ctx.state = (counter, n, body, leaves, outs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        counter, n, body, leaves, outs = ctx.state
        if ctx.remat:
            with torch.no_grad(), counter.repeat(n):
                body(0, *leaves)
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        want = [x for x in leaves if isinstance(x, torch.Tensor) and x.requires_grad]
        grads = iter(())
        if pairs and want:
            with counter.repeat(n):
                grads = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                                 [g for _, g in pairs], allow_unused=True))
        return (None, None, None, *(next(grads, None) if isinstance(x, torch.Tensor)
                                    and x.requires_grad else None for x in leaves))


def each_shard(n: int, body: Callable[..., Any], *, meta: bool, inputs: tuple | None = None
               ) -> list:
    """``[body(i) for i in range(n)]`` (``body(i, *inputs)`` when ``inputs``
    is given), the shards of a mesh one after another. Under a counter, when
    ``meta`` (the caller's inputs are ``meta`` tensors), every shard's body
    has the same shapes and no values, so ``body(0)`` runs once, is counted
    ``n`` times, and its result stands for every shard's (the caller
    promises equal shapes). Where a gradient is to be taken, the body must
    get every tensor it differentiates through ``inputs``: it then runs as
    one autograd node (:class:`_Repeated`) whose backward is counted ``n``
    times as well. Nothing else changes: on real tensors each shard runs."""
    call = body if inputs is None else (lambda i: body(i, *inputs))
    counter = active()
    if counter is None or not meta or n == 1:
        return [call(i) for i in range(n)]
    grad = inputs is not None and torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in inputs)
    if not grad:
        with counter.repeat(n):
            first = call(0)
        return [first] * n
    outs = _Repeated.apply(counter, n, body, *inputs)
    first = outs if len(outs) > 1 else outs[0]
    return [first] * n
