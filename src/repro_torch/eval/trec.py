"""TREC run-file and qrels I/O — the experiment subsystem's on-disk contract.

A *run* is the classic six-column format every TREC tool understands::

    <query_id> Q0 <doc_id> <rank> <score> <run_tag>

and qrels are the four-column judgment format::

    <query_id> 0 <doc_id> <grade>

Writers are deterministic byte-for-byte for identical inputs (scores are
formatted with ``%.17g``, which round-trips float64 exactly), which is what
lets the resumable scan job assert *bit-identical run files* after a
kill/resume — a stronger artifact-level guarantee than comparing in-memory
arrays. Ids are written as ``q<i>`` / ``d<j>`` and parsed back to ints.
"""

from __future__ import annotations

import os

import numpy as np


def _write_atomic(path: str, text: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def write_run(
    path: str,
    ids: np.ndarray,
    scores: np.ndarray,
    *,
    run_tag: str,
    valid: np.ndarray | None = None,
) -> str:
    """Write ``ids/scores [n_q, k]`` (rank order) as a TREC run file.

    ``valid`` masks out empty combiner slots (``topk.valid_mask``); masked
    rows are simply omitted, as TREC permits ragged run depths per query.
    """
    ids = np.asarray(ids)
    scores = np.asarray(scores)
    lines = []
    for qi in range(ids.shape[0]):
        for rank in range(ids.shape[1]):
            if valid is not None and not valid[qi, rank]:
                continue
            lines.append(
                f"q{qi} Q0 d{int(ids[qi, rank])} {rank + 1} "
                f"{float(scores[qi, rank]):.17g} {run_tag}"
            )
    return _write_atomic(path, "\n".join(lines) + "\n")


def read_run(path: str, *, depth: int | None = None) -> tuple[np.ndarray, np.ndarray, str]:
    """Parse a run file back to ``(ids, scores, run_tag)`` dense arrays.

    Missing (omitted) ranks come back as ``(-1, -inf)`` — the same empty-slot
    sentinels as :class:`repro_torch.core.topk.TopKState`, so a written+reread run
    evaluates identically to the in-memory state it came from.
    """
    rows: dict[int, list[tuple[int, int, float]]] = {}
    tag = ""
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, _, did, rank, score, tag = line.split()
            rows.setdefault(int(qid[1:]), []).append(
                (int(rank), int(did[1:]), float(score))
            )
    if not rows:
        return np.zeros((0, 0), np.int32), np.zeros((0, 0), np.float64), tag
    n_q = max(rows) + 1
    if depth is None:
        depth = max(r for entries in rows.values() for r, _, _ in entries)
    ids = np.full((n_q, depth), -1, np.int32)
    scores = np.full((n_q, depth), -np.inf, np.float64)
    for qi, entries in rows.items():
        for rank, did, score in entries:
            ids[qi, rank - 1] = did
            scores[qi, rank - 1] = score
    return ids, scores, tag


def write_qrels(path: str, qrels: np.ndarray) -> str:
    """Write a grade matrix ``[n_q, n_docs]`` as four-column TREC qrels
    (only judged, i.e. grade > 0, pairs are emitted)."""
    qrels = np.asarray(qrels)
    lines = []
    for qi, doc in zip(*np.nonzero(qrels > 0)):
        lines.append(f"q{qi} 0 d{int(doc)} {int(qrels[qi, doc])}")
    return _write_atomic(path, "\n".join(lines) + "\n")


def read_qrels(path: str, *, n_queries: int | None = None, n_docs: int | None = None) -> np.ndarray:
    """Parse qrels back to a dense grade matrix."""
    triples = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            qid, _, did, grade = line.split()
            triples.append((int(qid[1:]), int(did[1:]), int(grade)))
    n_q = n_queries if n_queries is not None else max(q for q, _, _ in triples) + 1
    n_d = n_docs if n_docs is not None else max(d for _, d, _ in triples) + 1
    out = np.zeros((n_q, n_d), np.int8)
    for q, d, g in triples:
        out[q, d] = g
    return out
