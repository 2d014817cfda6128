"""Host-side 1D graph partitioning: bucket edges by destination shard (the
port's copy of `repro.data.graph_prep`, host numpy).

The sharded full-graph forward (models/gnn.py, mode="bucketed") contracts
that mesh shard ``s`` receives exactly the edges whose destination node lies
in its contiguous node range, padded to a uniform bucket size with ghost
edges (``dst = n_nodes``, dropped by the out-of-range segment ids). This is
the standard vertex-partitioned (1D) layout; the partition is computed once
on hosts as part of data loading.
"""

from __future__ import annotations

import numpy as np


def bucket_edges(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    n_nodes: int,
    n_shards: int,
    bucket_size: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (src_bucketed, dst_bucketed, bucket_size): arrays of length
    ``n_shards * bucket_size`` where slab s holds edges with
    ``dst // (n_nodes/n_shards) == s`` (ghost-padded)."""
    assert n_nodes % n_shards == 0, (n_nodes, n_shards)
    n_loc = n_nodes // n_shards
    shard_of = dst // n_loc
    counts = np.bincount(shard_of, minlength=n_shards)
    if bucket_size is None:
        bucket_size = int(counts.max())
    if counts.max() > bucket_size:
        raise ValueError(
            f"bucket overflow: max shard load {counts.max()} > bucket {bucket_size}; "
            "increase the padded edge budget (skew beyond the 1.3× allowance)"
        )
    order = np.argsort(shard_of, kind="stable")
    src_s, dst_s = src[order], dst[order]
    out_src = np.zeros((n_shards, bucket_size), np.int32)
    out_dst = np.full((n_shards, bucket_size), n_nodes, np.int32)  # ghosts
    start = 0
    for s in range(n_shards):
        c = counts[s]
        out_src[s, :c] = src_s[start : start + c]
        out_dst[s, :c] = dst_s[start : start + c]
        start += c
    return out_src.reshape(-1), out_dst.reshape(-1), bucket_size
