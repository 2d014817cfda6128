"""Deterministic segment reduces: sum, max, min and count of rows by id.

The reference reduces with ``jax.ops.segment_*`` (the GNN's message
passing, the ragged embedding bag). torch's ``index_add_`` and
``scatter_reduce`` add with atomics on a card, so their bits change from
run to run. Here the rows are grouped by id once (:func:`segments`, a
stable sort, skipped when the ids already come sorted), and every reduce
is ``torch.segment_reduce`` over those sorted runs: each output reads its
own run in order, on the CPU and on the card, with no atomics in the
forward or the backward.

A gather whose gradient is a scatter, :func:`gather`, takes the same
road back: its backward is a segment sum of the cotangent rows grouped by
the row they read. Neither torch gather is deterministic on both devices:
``F.embedding``'s backward gave other bits from run to run on an H100
(torch 2.11, CUDA 12.8; 200,000 rows into 500), and an indexed gather's
backward (``index_put_`` with accumulation) on the CPU.

The max and min take their own backward (:class:`_Extreme`): torch's
``segment_reduce`` backward splits a tied maximum's gradient among the
tied rows only where the gradient is positive (torch 2.13 on the CPU:
``[1, 1, 1]`` with gradient -0.5 gives each row -0.5, with 0.5 each row
1/6), while ``jax.ops.segment_max`` splits it every time.

The rules are those of ``jax.ops.segment_*``:

* an id outside ``[0, n)`` is dropped (a ghost edge, ``dst = n_nodes``);
* an empty segment gives 0 for sum and count, ``-inf`` for max and
  ``+inf`` for min;
* a tied max or min splits its gradient equally among the tied rows.

On ``meta`` tensors (an op counter's reckoning of a step, no data) the
host reads cannot run, and the general path is taken: the ids are sorted,
every row counts as kept, and :meth:`Segments.blocks` cuts the ids into
equal ranges as if the rows spread evenly over them. Results on real
tensors do not change.
"""

from __future__ import annotations

import numpy as np
import torch


class Segments:
    """Rows grouped by id: the rows with id ``i`` are positions
    ``offsets[i]:offsets[i + 1]`` of the kept rows in id order.

    ``order`` holds the kept rows' positions in that order; ``None`` when
    the kept rows are already rows ``start:start + n_valid``, in order.
    Build one with :func:`segments`, once per graph.
    """

    def __init__(self, order: torch.Tensor | None, offsets: torch.Tensor, n: int,
                 n_valid: int, start: int = 0, host_offsets: np.ndarray | None = None):
        self.order = order
        self.offsets = offsets
        self.n = n
        self.n_valid = n_valid
        self.start = start
        self._host_offsets = host_offsets

    def take(self, rows: torch.Tensor) -> torch.Tensor:
        """The kept rows of ``rows [E, ...]``, in id order."""
        if self.order is None:
            return rows[self.start:self.start + self.n_valid]
        return rows[self.order]

    def ids(self) -> torch.Tensor:
        """Each kept row's id, in id order (int64)."""
        counts = self.offsets[1:] - self.offsets[:-1]
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.offsets.device), counts,
            output_size=self.n_valid)

    def reduce(self, rows: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("sum", "max" or "min") over kept rows already in id order
        (``take``'s result) -> ``[n, ...]``."""
        if op == "sum":
            return _segment_reduce(rows, "sum", self.offsets)
        if op not in ("max", "min"):
            raise ValueError(f"unknown segment reduce {op!r}")
        return _Extreme.apply(rows, self, op)

    def sum(self, rows: torch.Tensor) -> torch.Tensor:
        """The sum of ``rows [E, ...]`` by id -> ``[n, ...]``."""
        return self.reduce(self.take(rows), "sum")

    def count(self, dtype=torch.float32) -> torch.Tensor:
        """Rows with each id -> ``[n]`` in ``dtype``."""
        return (self.offsets[1:] - self.offsets[:-1]).to(dtype)

    def grouped(self) -> Segments:
        """The grouping of :meth:`ids` (the kept rows' ids in id order): the
        same offsets, its rows already in order from 0."""
        return Segments(None, self.offsets, self.n, self.n_valid, 0, self._host_offsets)

    def host_offsets(self) -> np.ndarray:
        if self._host_offsets is None:
            self._host_offsets = self.offsets.cpu().numpy()
        return self._host_offsets

    def blocks(self, max_rows: int) -> list[tuple[int, int, Segments]]:
        """Cut the ids into consecutive ranges ``[i0, i1)`` whose rows number
        at most ``max_rows`` (an id with more rows makes a range alone):
        ``(i0, i1, segments of that range)``, its ids counted from ``i0``.
        No id's rows are split, so a reduce over the ranges gives each id
        the bits of one reduce over all of them."""
        if self.offsets.is_meta:
            return self._even_blocks(max_rows)
        off = self.host_offsets()
        out, i0 = [], 0
        while i0 < self.n:
            i1 = int(np.searchsorted(off, off[i0] + max_rows, side="right")) - 1
            i1 = min(max(i1, i0 + 1), self.n)
            out.append((i0, i1, self._range(i0, i1)))
            i0 = i1
        return out

    def _even_blocks(self, max_rows: int) -> list[tuple[int, int, Segments]]:
        """``blocks`` without the offsets' values (``meta``): equal id
        ranges, each taking its share of the rows."""
        n_blocks = max(1, -(-self.n_valid // max_rows))
        out = []
        for j in range(min(n_blocks, self.n)):
            i0, i1 = self.n * j // n_blocks, self.n * (j + 1) // n_blocks
            e0, e1 = self.n_valid * j // n_blocks, self.n_valid * (j + 1) // n_blocks
            order = None if self.order is None else self.order[e0:e1]
            out.append((i0, i1, Segments(order, self.offsets[i0:i1 + 1] - e0, i1 - i0,
                                         e1 - e0, self.start + e0)))
        return out

    def _range(self, i0: int, i1: int) -> Segments:
        off = self.host_offsets()
        e0, e1 = int(off[i0]), int(off[i1])
        order = None if self.order is None else self.order[e0:e1]
        return Segments(order, self.offsets[i0:i1 + 1] - e0, i1 - i0, e1 - e0,
                        self.start + e0, off[i0:i1 + 1] - e0)


def _segment_reduce(rows, op, offsets):
    return torch.segment_reduce(rows, op, offsets=offsets, axis=0, unsafe=True)


class _Extreme(torch.autograd.Function):
    """Segment max or min whose backward splits each output's gradient
    equally among the rows that attain it, as ``jax.ops.segment_max``'s
    does: a gather of each row's output and a segment sum of the hits."""

    @staticmethod
    def forward(ctx, rows, seg, op):
        out = _segment_reduce(rows, op, seg.offsets)
        ctx.seg = seg
        ctx.save_for_backward(rows, out)
        return out

    @staticmethod
    def backward(ctx, g):
        rows, out = ctx.saved_tensors
        seg = ctx.seg
        ids = seg.ids()
        hit = (rows == out.index_select(0, ids)).to(g.dtype)
        share = g / torch.clamp(_segment_reduce(hit, "sum", seg.offsets), min=1.0)
        return hit * share.index_select(0, ids), None, None


class _Gather(torch.autograd.Function):
    """``table[idx]``; the backward sums the cotangent rows of each table row
    in order (``seg`` groups ``idx`` by value)."""

    @staticmethod
    def forward(ctx, table, idx, seg):
        ctx.seg = seg
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.sum(g), None, None


def gather(table: torch.Tensor, idx: torch.Tensor, seg: Segments | None = None) -> torch.Tensor:
    """``table[idx]`` (``idx`` in ``[0, len(table))``) with a deterministic
    backward. ``seg`` is ``segments(idx, len(table))`` when the caller has
    it; it is built here when a gradient is wanted and not given."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    if seg is None:
        seg = segments(idx, table.shape[0])
    return _Gather.apply(table, idx, seg)


def segments(ids: torch.Tensor, n: int) -> Segments:
    """Group the rows of ``ids [E]`` by id in ``[0, n)``, dropping the
    rest. A stable sort keeps rows of one id in their given order; ids that
    already come sorted (with the dropped ones, if any, at the end) are not
    sorted again. Reads two numbers on the host (none on ``meta``: sorted,
    every row kept)."""
    key = ids.long()
    key = torch.where((key >= 0) & (key < n), key, n)  # dropped rows sort last
    if key.is_meta or (key.numel() > 1 and not bool((key[1:] >= key[:-1]).all())):
        order = torch.sort(key, stable=True).indices
        key = key[order]
    else:
        order = None
    offsets = torch.searchsorted(key, torch.arange(n + 1, device=key.device))
    n_valid = key.numel() if key.is_meta else int(offsets[-1])
    if order is not None:
        order = order[:n_valid]
    return Segments(order, offsets, n, n_valid)
