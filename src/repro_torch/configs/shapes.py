"""Shape registries: every assigned (architecture × input-shape) cell (the
port's copy of `repro.configs.shapes`, pure data).

All global batch/edge/candidate counts divide both production meshes
(256 and 512 ways) — where a public number doesn't (cora's 10 556 edges,
the 10⁶ candidates), the generator pads to the next divisible size and the
pad rows are masked out (out-of-range segment ids / -inf scores), noted here.
"""

from __future__ import annotations

from repro_torch.configs.base import ShapeSpec


def _round_to(x: int, m: int) -> int:
    return -(-x // m) * m


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm",
        "full_graph",
        {
            "n_nodes": _round_to(2708, 512),  # cora, padded 2708 -> 3072
            "n_edges": 10556,
            # dst-bucketed 1D partition: uniform per-shard slabs with a 4×
            # skew allowance (cora is tiny and very skewed)
            "n_edges_padded": _round_to(4 * 10556, 4096),
            "d_feat": 1433,
            "n_classes": 7,
        },
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg",
        "minibatch",
        {
            "n_nodes": 232_965,  # reddit
            "n_edges": 114_615_892,
            "batch_nodes": 1024,
            "fanout": (15, 10),
            "d_feat": 602,
            "n_classes": 41,
        },
    ),
    "ogb_products": ShapeSpec(
        "ogb_products",
        "full_graph",
        {
            "n_nodes": _round_to(2_449_029, 512),  # padded -> 2 449 408
            "n_edges": 61_859_140,
            # 1.3× skew allowance for the dst-bucketed partition
            "n_edges_padded": _round_to(int(1.3 * 61_859_140), 4096),
            "d_feat": 100,
            "n_classes": 47,
        },
    ),
    "molecule": ShapeSpec(
        "molecule",
        "batched_graphs",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 28, "n_classes": 2},
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "rec_train", {"batch": 65_536}),
    "serve_p99": ShapeSpec("serve_p99", "rec_serve", {"batch": 512}),
    "serve_bulk": ShapeSpec("serve_bulk", "rec_serve", {"batch": 262_144}),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand",
        "retrieval",
        # 10^6 candidates padded to 2^20 (divides 256 and 512)
        {"batch": 1, "n_candidates": 1_048_576},
    ),
}

MIREX_SHAPES = {
    "scan_50q": ShapeSpec(
        "scan_50q", "scan", {"n_docs": 1_048_576, "n_queries": 64, "doc_len": 128}
    ),
    "scan_5kq": ShapeSpec(
        "scan_5kq", "scan", {"n_docs": 1_048_576, "n_queries": 5120, "doc_len": 128}
    ),
    "dense_scan": ShapeSpec(
        "dense_scan", "dense_scan", {"n_docs": 16_777_216, "n_queries": 4096, "dim": 256}
    ),
}
