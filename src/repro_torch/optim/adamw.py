"""AdamW, its cosine schedule and global-norm clipping (the port's copy of
`repro.optim.adamw`).

The math is the reference's: clip first, then each leaf updated in float32
and cast back to the parameter's dtype (there is no float32 master copy),
moments in ``opt_dtype`` (float32 by default), ``b1`` 0.9, ``b2`` 0.95, weight
decay 0.1. ``step`` is a 0-d int32 tensor on the parameters' device and the
schedule reads it there, so an update never waits for the host.

Trees are dicts of tensors (nested); leaves are visited in sorted-key order,
the reference's ``jax.tree.leaves`` order, which fixes the order of the
global norm's sum. :func:`adamw_update` writes the new parameters and
moments into the tensors it is given (the reference donates them to its
jitted step), so a step holds no second copy of the training state; it
returns them as well.

``opt_state_specs`` gives the moments' sharding specs as the reference's
(the parameters', plus ZeRO-1: a ``dp``-replicated moment is sharded over
``dp`` on its first divisible dim), each a tuple of axis groups.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.transformer import ParamSpec


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    m: dict
    v: dict


def tree_leaves(tree) -> list:
    """Leaves in sorted-key order (the reference's tree order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest`` (same
    structure), keeping the dict structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def adamw_state_shapes(param_shapes, moment_dtype=torch.float32) -> AdamWState:
    """The state's shapes and dtypes (`ParamSpec` leaves) from the
    parameters' (any leaf with a ``shape``)."""
    md = lambda p: ParamSpec(tuple(p.shape), moment_dtype)  # noqa: E731
    return AdamWState(
        step=ParamSpec((), torch.int32),
        m=tree_map(md, param_shapes),
        v=tree_map(md, param_shapes),
    )


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warm-up for ``warmup`` steps, then a cosine decay
    to 0 at ``total``. ``step`` is an integer tensor (on any device); the
    result is a float32 tensor beside it, computed in float32 as the
    reference's."""

    def lr(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled so their global L2 norm is at most max_norm, the
    norm)``; the squares summed in float32, leaf by leaf in tree order."""
    leaves = tree_leaves(grads)
    g2 = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        g2 = g2 + torch.sum(torch.square(g.to(torch.float32)))
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
):
    """One AdamW step: ``(params, state, gnorm)``. ``lr`` is a float or a
    schedule of the step (on the device). The parameters and moments are
    updated in place, each leaf in float32 (``m2 = b1 m + (1 - b1) g``,
    ``v2 = b2 v + (1 - b2) g g``, bias-corrected, plus weight decay on the
    parameter), then cast back to its own dtype."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m2 = b1 * m.to(torch.float32) + (1 - b1) * g
        v2 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        del g
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        u = u + weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr_t * u)
        m.copy_(m2)
        v.copy_(v2)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        upd(p, g, m, v)
    state.step.copy_(step)
    return params, state, gnorm


def _zero1_spec(spec: tuple, shape: tuple, rules: Any, dp_size: int) -> tuple:
    """Extra-shard a moment over dp on the first divisible unsharded dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    if any(a in used for a in rules.dp):
        return spec  # already dp-sharded somewhere
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dp_size == 0 and dim > 0:
            entries[i] = rules.dp if len(rules.dp) > 1 else rules.dp[0]
            return tuple(entries)
    return spec


def opt_state_specs(param_specs, param_shapes, rules: Any, dp_size: int, *, zero1: bool = True):
    """Moment specs = the parameters' (+ ZeRO-1 over ``dp`` when ``zero1``);
    the step replicated (``()``)."""
    mspec = (tree_map(lambda sp, sh: _zero1_spec(sp, tuple(sh.shape), rules, dp_size),
                      param_specs, param_shapes) if zero1 else param_specs)
    return AdamWState(step=(), m=mspec, v=mspec)
