"""TREC-style evaluation: rank metrics, run/qrels I/O, significance testing.

The measurement half of the batch experiment engine (`repro_torch.experiments`):
scan jobs produce run files, this package turns (run, qrels) into MAP / P@k /
NDCG / MRR / recall report cards and paired-randomization p-values between
runs. Also the single source of truth for quality numbers elsewhere in the
repo (`benchmarks/quality_pk.py` asserts through these functions).
"""

from repro_torch.eval import metrics, significance, trec
from repro_torch.eval.metrics import (
    average_precision,
    evaluate_run,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
    reciprocal_rank,
)
from repro_torch.eval.significance import SignificanceResult, paired_randomization_test
from repro_torch.eval.trec import read_qrels, read_run, write_qrels, write_run

__all__ = [
    "metrics",
    "significance",
    "trec",
    "average_precision",
    "evaluate_run",
    "ndcg_at_k",
    "precision_at_k",
    "recall_at_k",
    "reciprocal_rank",
    "SignificanceResult",
    "paired_randomization_test",
    "read_qrels",
    "read_run",
    "write_qrels",
    "write_run",
]
