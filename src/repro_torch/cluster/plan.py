"""Shard plans — the cluster's unit of work assignment.

A :class:`ShardPlan` cuts the collection into contiguous, chunk-aligned,
equal slices covering ``[0, n_docs)`` exactly once; each shard's global
``doc_id_offset`` is its start row, so local top-k ids map to global ids by
one sentinel-preserving add. Chunk alignment keeps every chunk's scores a
function of its rows alone, so merged results are identical at any shard
count. :func:`plan_for_mesh` cuts one shard per device along a mesh's scan
axes (`repro_torch.distributed.sharding`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.core.pipeline import tree_map
from repro_torch.distributed.sharding import AxisRules, Mesh, rules_for_mesh


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous corpus slice: global rows ``[start, stop)``."""

    index: int
    start: int
    stop: int

    @property
    def n_rows(self) -> int:
        return self.stop - self.start

    @property
    def doc_id_offset(self) -> int:
        """Local row -> global doc id offset (== start: slices are contiguous)."""
        return self.start

    def take(self, docs: Any) -> Any:
        """Slice this shard's rows out of a docs tree."""
        return tree_map(lambda x: x[self.start : self.stop], docs)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A full partition of the corpus into scan shards."""

    n_docs: int
    chunk_size: int
    shards: tuple[Shard, ...]
    axis_names: tuple[str, ...] = ()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def describe(self) -> dict:
        """JSON-able geometry for progress manifests / reports."""
        return {
            "n_docs": self.n_docs,
            "chunk_size": self.chunk_size,
            "n_shards": self.n_shards,
            "axis_names": list(self.axis_names),
            "shards": [[s.start, s.stop] for s in self.shards],
        }


def plan_shards(
    n_docs: int,
    *,
    n_shards: int,
    chunk_size: int,
    axis_names: Sequence[str] = (),
) -> ShardPlan:
    """Cut ``[0, n_docs)`` into ``n_shards`` equal chunk-aligned contiguous
    slices (pad the corpus first if it doesn't divide)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_docs % n_shards:
        raise ValueError(
            f"{n_docs} docs not divisible into {n_shards} equal shards; "
            "pad the corpus first (pipeline.pad_leading with PAD_TOKEN rows)"
        )
    per_shard = n_docs // n_shards
    if per_shard % chunk_size:
        raise ValueError(
            f"shard size {per_shard} not a multiple of chunk_size {chunk_size}"
        )
    shards = tuple(
        Shard(index=i, start=i * per_shard, stop=(i + 1) * per_shard)
        for i in range(n_shards)
    )
    return ShardPlan(
        n_docs=n_docs, chunk_size=chunk_size, shards=shards, axis_names=tuple(axis_names)
    )


def mesh_scan_axes(mesh: Mesh, rules: AxisRules | None = None) -> tuple[str, ...]:
    """The physical axes behind the logical "scan" axis: all of them."""
    rules = rules if rules is not None else rules_for_mesh(mesh)
    return rules.scan_axes


def plan_for_mesh(
    mesh: Mesh,
    n_docs: int,
    *,
    chunk_size: int,
    rules: AxisRules | None = None,
    axis_names: Sequence[str] | None = None,
) -> ShardPlan:
    """One shard per device along the scan axes of ``mesh``.

    ``axis_names=None`` shards over the logical "scan" axis (every mesh axis
    — the MIREX default); pass a subset to scan on a slice of the mesh, e.g.
    ``("data",)`` to keep "model" free for tensor parallelism.
    """
    if axis_names is None:
        axis_names = mesh_scan_axes(mesh, rules)
    n_shards = 1
    for a in axis_names:
        n_shards *= mesh.shape[a]
    return plan_shards(n_docs, n_shards=n_shards, chunk_size=chunk_size, axis_names=axis_names)
