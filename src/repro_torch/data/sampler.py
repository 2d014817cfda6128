"""Host-side fixed-fanout neighbor sampler (GraphSAGE-style) for minibatch_lg
(the port's copy of `repro.data.sampler`, host numpy).

Builds a CSR adjacency once, then per step samples a fixed-fanout computation
tree for a seed batch: deterministic given (seed, step) — the restart-safe
contract shared with the rest of the data pipeline. Sampling is with
replacement (nodes with degree < fanout repeat neighbors; isolated nodes
self-loop), which keeps every tensor statically shaped for jit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    feats: np.ndarray  # [N, F]
    labels: np.ndarray  # [N]

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def build_csr(src: np.ndarray, dst: np.ndarray, feats: np.ndarray, labels: np.ndarray) -> CSRGraph:
    """CSR over *incoming* edges: neighbors(v) = sources of edges into v."""
    n = feats.shape[0]
    order = np.argsort(dst, kind="stable")
    indices = src[order]
    counts = np.bincount(dst, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=indices, feats=feats, labels=labels)


def sample_neighbors(g: CSRGraph, nodes: np.ndarray, fanout: int, rng: np.random.Generator) -> np.ndarray:
    """[len(nodes), fanout] sampled in-neighbors (self-loop when isolated)."""
    lo = g.indptr[nodes]
    hi = g.indptr[nodes + 1]
    deg = hi - lo
    pick = rng.integers(0, np.maximum(deg, 1)[:, None], size=(nodes.shape[0], fanout))
    neigh = g.indices[np.minimum(lo[:, None] + pick, len(g.indices) - 1 if len(g.indices) else 0)]
    return np.where(deg[:, None] > 0, neigh, nodes[:, None]).astype(np.int32)


def sample_batch(
    g: CSRGraph,
    *,
    batch_nodes: int,
    fanout: tuple[int, int],
    seed: int,
    step: int,
) -> dict[str, np.ndarray]:
    """One training batch: seeds + 2-hop computation-tree features."""
    rng = np.random.default_rng((seed, step))
    seeds = rng.integers(0, g.n_nodes, size=batch_nodes).astype(np.int32)
    k1, k2 = fanout
    hop1 = sample_neighbors(g, seeds, k1, rng)  # [B, K1]
    hop2 = sample_neighbors(g, hop1.reshape(-1), k2, rng).reshape(batch_nodes, k1, k2)
    return {
        "seed_x": g.feats[seeds],
        "hop1_x": g.feats[hop1],
        "hop2_x": g.feats[hop2],
        "labels": g.labels[seeds].astype(np.int32),
    }
