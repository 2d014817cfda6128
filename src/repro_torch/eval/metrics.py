"""TREC-style rank metrics over (run, qrels) pairs — host-side numpy.

Evaluation is deliberately *not* a device dataflow: runs are small (``n_q × k``
after the combiner bound) and TREC semantics are full of ragged, data-dependent
bookkeeping (per-query relevant counts, graded gains, rank cutoffs) that belong
on the host. Everything takes

    run_ids [n_q, depth] int   — ranked doc ids, best first; ``-1`` = empty slot
    qrels   [n_q, n_docs] int/bool — relevance grades (binary qrels are grade 1)

and returns **per-query** vectors; the scalar aggregate (MAP, MRR, mean P@k …)
is just ``.mean()``. Keeping per-query values first-class is what makes the
paired randomization significance test (`repro_torch.eval.significance`) a one-liner
downstream instead of a re-evaluation.

Conventions follow trec_eval: AP divides by the number of relevant documents
(not the cutoff), queries with no relevant documents score 0 everywhere, and
NDCG uses exponential gains ``2^grade - 1`` with ``log2(rank+1)`` discounts.
"""

from __future__ import annotations

import numpy as np


def _grades_at_ranks(run_ids: np.ndarray, qrels: np.ndarray) -> np.ndarray:
    """Relevance grade of each ranked position, 0 for empty (-1) slots."""
    run_ids = np.asarray(run_ids)
    qrels = np.asarray(qrels)
    if run_ids.ndim != 2 or qrels.ndim != 2 or run_ids.shape[0] != qrels.shape[0]:
        raise ValueError(f"shape mismatch: run {run_ids.shape} vs qrels {qrels.shape}")
    safe = np.clip(run_ids, 0, qrels.shape[1] - 1)
    # gather first, widen after: the same values as widening the whole
    # [n_q, n_docs] matrix, without a float64 copy of it per call
    g = np.take_along_axis(qrels, safe, axis=1).astype(np.float64)
    return np.where(run_ids >= 0, g, 0.0)


def precision_at_k(run_ids: np.ndarray, qrels: np.ndarray, k: int) -> np.ndarray:
    """P@k per query (graded qrels are binarized as grade > 0)."""
    rel = _grades_at_ranks(run_ids[:, :k], qrels) > 0
    return rel.sum(axis=1) / float(k)


def _relevant_counts(qrels: np.ndarray) -> np.ndarray:
    return (np.asarray(qrels) > 0).sum(axis=1)


def recall_at_k(run_ids: np.ndarray, qrels: np.ndarray, k: int, *,
                n_rel: np.ndarray | None = None) -> np.ndarray:
    """Fraction of each query's relevant docs retrieved in the top k
    (``n_rel``: each query's relevant count, when the caller has it)."""
    rel = _grades_at_ranks(run_ids[:, :k], qrels) > 0
    n_rel = _relevant_counts(qrels) if n_rel is None else n_rel
    return np.where(n_rel > 0, rel.sum(axis=1) / np.maximum(n_rel, 1), 0.0)


def average_precision(run_ids: np.ndarray, qrels: np.ndarray, *,
                      n_rel: np.ndarray | None = None) -> np.ndarray:
    """AP per query over the full run depth; MAP = ``average_precision().mean()``."""
    rel = _grades_at_ranks(run_ids, qrels) > 0
    ranks = np.arange(1, rel.shape[1] + 1, dtype=np.float64)
    prec_at_rank = np.cumsum(rel, axis=1) / ranks  # P@rank at every position
    n_rel = _relevant_counts(qrels) if n_rel is None else n_rel
    ap_sum = (prec_at_rank * rel).sum(axis=1)
    return np.where(n_rel > 0, ap_sum / np.maximum(n_rel, 1), 0.0)


def reciprocal_rank(run_ids: np.ndarray, qrels: np.ndarray) -> np.ndarray:
    """1/rank of the first relevant doc per query (0 if none retrieved)."""
    rel = _grades_at_ranks(run_ids, qrels) > 0
    first = np.argmax(rel, axis=1)  # 0 when no hit — disambiguate via any()
    return np.where(rel.any(axis=1), 1.0 / (first + 1.0), 0.0)


def _row_grades(qrels: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
    """Each query's positive grades sorted descending, and its count of zero
    grades: what the metrics need of a corpus-wide qrels row, in one pass."""
    pos, zeros = [], np.empty(qrels.shape[0], np.int64)
    for i, row in enumerate(qrels):
        nonzero = row[row != 0]
        pos.append(np.sort(nonzero[nonzero > 0])[::-1])
        zeros[i] = row.size - nonzero.size
    return pos, zeros


def _ideal_grades(qrels: np.ndarray, k: int, rows=None) -> np.ndarray:
    """Each query's grades sorted descending, truncated to ``k``, as float64
    (``rows``: :func:`_row_grades` of ``qrels``, when the caller has it).

    The same values as sorting every row in full, without the full sort: a
    row's ``k`` largest grades are its positive grades, then zeros (when the
    row has enough of them), else whatever a partition keeps. A corpus-wide
    qrels matrix is mostly zeros, so that costs a linear pass per row.
    """
    n = qrels.shape[1]
    if k >= n:
        return np.sort(qrels, axis=1)[:, ::-1][:, :k].astype(np.float64)
    pos_rows, zeros = _row_grades(qrels) if rows is None else rows
    out = np.empty((qrels.shape[0], k), dtype=qrels.dtype)
    for i, pos in enumerate(pos_rows):
        need = k - pos.size
        if need <= 0:
            out[i] = pos[:k]
        elif zeros[i] >= need:
            out[i, : pos.size] = pos
            out[i, pos.size :] = 0
        else:
            out[i] = np.sort(np.partition(qrels[i], n - k)[n - k :])[::-1]
    return out.astype(np.float64)


def ndcg_at_k(run_ids: np.ndarray, qrels: np.ndarray, k: int, *, rows=None) -> np.ndarray:
    """NDCG@k per query with exponential gains (graded or binary qrels;
    ``rows``: :func:`_row_grades` of ``qrels``, when the caller has it).

    A run shallower than ``k`` simply contributes no gain at the missing
    ranks (ideal DCG still uses the full ``k``), matching trec_eval."""
    gains = 2.0 ** _grades_at_ranks(run_ids[:, :k], qrels) - 1.0
    discounts = 1.0 / np.log2(np.arange(2, k + 2, dtype=np.float64))
    dcg = (gains * discounts[: gains.shape[1]]).sum(axis=1)
    # ideal ranking: each query's grades sorted descending, truncated to k
    ideal = _ideal_grades(np.asarray(qrels), k, rows)
    idcg = ((2.0**ideal - 1.0) * discounts[: ideal.shape[1]]).sum(axis=1)
    return np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)


PER_QUERY_METRICS = {
    "ap": average_precision,
    "rr": reciprocal_rank,
}
AT_K_METRICS = {
    "p": precision_at_k,
    "recall": recall_at_k,
    "ndcg": ndcg_at_k,
}


def evaluate_run(
    run_ids: np.ndarray,
    qrels: np.ndarray,
    *,
    ks: tuple[int, ...] = (5, 10, 20),
) -> dict:
    """The full report card for one run.

    Returns ``{"aggregate": {...}, "per_query": {...}}`` where aggregates are
    floats (``map``, ``mrr``, ``p@k`` / ``recall@k`` / ``ndcg@k`` per cutoff)
    and per-query vectors back the significance test.
    """
    depth = np.asarray(run_ids).shape[1]
    qrels = np.asarray(qrels)
    # the qrels' rows read once for every metric, not once a metric and cutoff
    rows = _row_grades(qrels)
    n_rel = np.array([pos.size for pos in rows[0]], dtype=np.int64)
    per_query: dict[str, np.ndarray] = {
        "ap": average_precision(run_ids, qrels, n_rel=n_rel),
        "rr": reciprocal_rank(run_ids, qrels),
    }
    for k in ks:
        if k > depth:
            raise ValueError(f"cutoff {k} exceeds run depth {depth}")
        per_query[f"p@{k}"] = precision_at_k(run_ids, qrels, k)
        per_query[f"recall@{k}"] = recall_at_k(run_ids, qrels, k, n_rel=n_rel)
        per_query[f"ndcg@{k}"] = ndcg_at_k(run_ids, qrels, k, rows=rows)
    aggregate = {
        "map" if name == "ap" else "mrr" if name == "rr" else name: float(v.mean())
        for name, v in per_query.items()
    }
    return {"aggregate": aggregate, "per_query": per_query}
