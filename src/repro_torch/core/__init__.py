"""MIREX core on torch: sequential-scan retrieval as a MapReduce-shaped dataflow."""

from repro_torch.core import anchors, pipeline, scan, scoring, topk
from repro_torch.core.scoring import CollectionStats, Scorer, get_scorer
from repro_torch.core.topk import TopKState

__all__ = [
    "anchors",
    "pipeline",
    "scan",
    "scoring",
    "topk",
    "CollectionStats",
    "Scorer",
    "get_scorer",
    "TopKState",
]
