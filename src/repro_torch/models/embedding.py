"""Embedding lookups (the port's copy of `repro.models.embedding`): the
per-field lookup, the padded and ragged bags, and the vocab-sharded lookup.

Indices follow JAX's rules, where the reference indexes bare: a negative id
wraps once (``-1`` is the last row) and an id past either end is clamped to
it; torch raises on the CPU and asserts on a card for those, so
:func:`jax_index` maps every id to the row JAX reads first. An id outside
``[-n, n)`` passes no gradient (:func:`outside_without_grad`): JAX clamps it
in the gather but drops it in the gather's transpose. Gathers whose
gradient is a scatter go through ``F.embedding``, whose backward on the
card sorts instead of adding atomically, so a training step gives the same
bits every run.

``make_sharded_field_embed`` runs the reference's ``shard_map`` the way
`repro_torch.models.moe.make_moe_layer` does: it takes the whole table and
ids, gives each shard its rows of the table (over ``tp``) and of the batch
(over the batch axes) on its mesh device, and sums the ``tp`` partials left
to right on the first shard's device (the ``psum``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import segment


def jax_index(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The row JAX's indexing reads for ``ids`` into ``n`` rows: negative
    ids wrap once, then every id is clamped into ``[0, n)``."""
    ids = torch.where(ids < 0, ids + n, ids)
    return ids.clamp(0, n - 1)


def outside_without_grad(rows: torch.Tensor, ids: torch.Tensor, n: int,
                         table: torch.Tensor) -> torch.Tensor:
    """``rows [..., D]`` looked up for ``ids [...]`` into ``n`` rows of
    ``table``, with no gradient through an id outside ``[-n, n)``: the same
    values, as JAX's clamped gather reads them, but the gather's transpose
    (a scatter that drops such an id) gives its clamped row nothing. Only
    under autograd; no host read."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return rows
    ok = (ids >= -n) & (ids < n)
    return torch.where(ok[..., None], rows, rows.detach())


def field_embed(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-field lookup. tables [F, V, D], ids [B, F] -> [B, F, D]."""
    f, v, d = tables.shape
    ids = ids.long()
    rows = jax_index(ids, v) + v * torch.arange(f, device=ids.device)
    return outside_without_grad(F.embedding(rows, tables.reshape(f * v, d)), ids, v, tables)


def embedding_bag(
    table: torch.Tensor,  # [V, D]
    ids: torch.Tensor,  # [B, L]
    *,
    mode: str = "mean",
    mask: torch.Tensor | None = None,  # [B, L] bool; default: ids >= 0
    weights: torch.Tensor | None = None,  # [B, L] per-sample weights
) -> torch.Tensor:
    """Padded-bag EmbeddingBag: gather + masked reduce -> [B, D]. The ids
    are clipped into the table first, as the reference clips them, so an id
    outside it passes its gradient to the end row it reads (where the mask
    keeps it)."""
    if mask is None:
        mask = ids >= 0
    e = F.embedding(ids.long().clamp(0, table.shape[0] - 1), table)  # [B, L, D]
    w = mask.to(e.dtype)
    if weights is not None:
        w = w * weights.to(e.dtype)
    e = e * w[..., None]
    if mode == "sum":
        return e.sum(1)
    if mode == "mean":
        return e.sum(1) / torch.clamp(w.sum(1, keepdim=True), min=1.0)
    if mode == "max":
        neg = torch.finfo(e.dtype).min
        return torch.amax(torch.where(mask[..., None], e, neg), dim=1)
    raise ValueError(mode)


def embedding_bag_ragged(
    table: torch.Tensor,  # [V, D]
    values: torch.Tensor,  # [nnz] ids
    segment_ids: torch.Tensor,  # [nnz] bag index, sorted
    num_bags: int,
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Ragged EmbeddingBag via a segment reduce -> [num_bags, D]; a segment
    id outside ``[0, num_bags)`` is dropped, a value outside ``[-V, V)`` reads
    its clamped row without a gradient, an empty bag is 0 (``sum``,
    ``mean``) or -inf (``max``), as ``jax.ops.segment_*`` give them. The
    reduce is `repro_torch.models.segment`'s (sorted runs, no atomics), and
    so is the lookup's backward (`segment.gather`; `F.embedding`'s gave
    other bits from run to run on an H100 at 200,000 ids into 500 rows), so
    a card gives the same bits every call, gradients included."""
    n = table.shape[0]
    values = values.long()
    e = outside_without_grad(segment.gather(table, jax_index(values, n)), values, n, table)
    seg = segment.segments(segment_ids, num_bags)
    if mode == "sum":
        return seg.sum(e)
    if mode == "mean":
        return seg.sum(e) / torch.clamp(seg.count(e.dtype), min=1.0)[:, None]
    if mode == "max":
        return seg.reduce(seg.take(e), "max")
    raise ValueError(mode)


def make_sharded_field_embed(mesh, tp_axis: str, batch_axes: tuple[str, ...]):
    """Vocab-sharded per-field lookup over ``mesh``: ``fn(tables [F, V, D],
    ids [B, F]) -> [B, F, D]``. Shard ``(di, ti)`` holds rows ``ti * V/tp``
    onwards of every field and the ``di``-th block of the batch; it looks up
    the ids in its range (the rest give 0) and the ``tp`` partials are
    summed. Ids are clamped into the shard's range before the lookup, as
    the reference's, so an id outside the table contributes nothing."""
    batch_axes = tuple(batch_axes)
    dp_sizes = [mesh.shape[a] for a in batch_axes]
    n_dp, n_tp = math.prod(dp_sizes), mesh.shape[tp_axis]

    def device(di: int, ti: int) -> torch.device:
        coords = dict.fromkeys(mesh.axis_names, 0)
        for a, n in zip(reversed(batch_axes), reversed(dp_sizes)):
            di, coords[a] = divmod(di, n)
        coords[tp_axis] = ti
        return mesh.devices[tuple(coords[a] for a in mesh.axis_names)]

    def local(tables_loc, ids, v0):
        f, v_loc, d = tables_loc.shape
        local_ids = ids.long() - v0
        in_range = (local_ids >= 0) & (local_ids < v_loc)
        rows = local_ids.clamp(0, v_loc - 1) + v_loc * torch.arange(f, device=ids.device)
        e = F.embedding(rows, tables_loc.reshape(f * v_loc, d))
        return torch.where(in_range[..., None], e, torch.zeros((), dtype=e.dtype,
                                                               device=e.device))

    def fn(tables, ids):
        f, v, d = tables.shape
        b = ids.shape[0]
        if v % n_tp or b % n_dp:
            raise ValueError(f"vocab {v} over {n_tp} tp shards, batch {b} over {n_dp} dp shards")
        v_loc, b_loc = v // n_tp, b // n_dp
        blocks = []
        for di in range(n_dp):
            total = None
            for ti in range(n_tp):
                dev = device(di, ti)
                part = local(tables[:, ti * v_loc:(ti + 1) * v_loc].to(dev),
                             ids[di * b_loc:(di + 1) * b_loc].to(dev), ti * v_loc)
                home = device(di, 0)
                total = part.to(home) if total is None else total + part.to(home)
            blocks.append(total)
        home = blocks[0].device
        return torch.cat([blk.to(home) for blk in blocks]) if len(blocks) > 1 else blocks[0]

    return fn
